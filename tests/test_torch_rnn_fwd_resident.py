"""The recurrent forward kernels K2 and K7 and their shape rule, on the CPU.

The bodies of each forward kernel (csrc/rnn_fwd_common.cuh's chain, with
the ticket or one cluster per barrier group, and the step kernel per time
step) run only on the card; they compute the plain loop's arithmetic in
another summation order. Here the routes a user calls (`gru_scan`,
`lstm_scan`, which take the plain versions on CPU tensors) are held to the
JAX kernels (`pallas_gru_scan`, `pallas_lstm_scan` in interpret mode) at
batches that cross a chunk of the resident body and a ragged row tile, and
the rule `rnn_body`, with the card's occupancy answer passed in, and its
chunk plans (the resident and the tiled body's) to the shapes the main
paths and the card tests use.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ss_tpu.ops.pallas_rnn import (_lstm_fwd, pallas_gru_scan,
                                      pallas_lstm_scan)
from dl4ss_tpu_torch.ops import rnn_kernels as k

# (T, B, H): B=1 a lone row in a 4-row tile; B=5 a ragged second tile;
# B=21 past one launch of the resident body at H=300 on 132 SMs
SHAPES = [(12, 1, 48), (9, 5, 37), (6, 21, 16)]


def _inputs(gates, t, b, h, seed, dtype):
    rng = np.random.default_rng(seed)
    s = 1 / np.sqrt(h)
    xp = (0.5 * rng.standard_normal((t, 2, b, gates * h))).astype(np.float32)
    wh = rng.uniform(-s, s, (2, h, gates * h)).astype(np.float32)
    bhn = rng.uniform(-s, s, (2, 1, h)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jax_in = (jnp.asarray(xp, jdt), jnp.asarray(wh, jdt), jnp.asarray(bhn))
    torch_in = (torch.as_tensor(xp).to(dtype), torch.as_tensor(wh).to(dtype),
                torch.as_tensor(bhn))
    return jax_in, torch_in


def _close(got, ref, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t,b,h", SHAPES)
def test_gru_scan_matches_pallas_gru_scan(dtype, tol, t, b, h):
    """K2's route against `_gru_fwd_kernel` in interpret mode. f32:
    summation order only, 1e-4. bf16: both carry h in bf16; one flipped
    rounding carries on through the steps, 2e-2."""
    (jxp, jwh, jb), (xp, wh, bhn) = _inputs(3, t, b, h, 30, dtype)
    ref = pallas_gru_scan(jxp, jwh, jb)
    hs = k.gru_scan(xp, wh, bhn)
    assert hs.dtype == dtype and tuple(hs.shape) == ref.shape == (t, 2, b, h)
    _close(hs, ref, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t,b,h", SHAPES)
def test_lstm_scan_matches_pallas_lstm_scan(dtype, tol, t, b, h):
    """K7's route against `_lstm_fwd_kernel` in interpret mode: hs through
    `pallas_lstm_scan`, cs through `_lstm_fwd`. Both keep c in f32 and
    round only the stored cs; tolerances as for the GRU."""
    (jxp, jwh, _), (xp, wh, _) = _inputs(4, t, b, h, 31, dtype)
    ref_hs = pallas_lstm_scan(jxp, jwh)
    _, ref_cs = _lstm_fwd(jxp, jwh)
    hs = k.lstm_scan(xp, wh)
    _, cs = k.lstm_scan_plain(xp, wh)
    assert hs.dtype == cs.dtype == dtype
    assert tuple(hs.shape) == ref_hs.shape == (t, 2, b, h)
    _close(hs, ref_hs, tol)
    _close(cs, ref_cs, tol)


# the shapes of the main paths (torch_multi: H=300 at B=16 a step or a
# batch, B=1 a request), the edge of one launch (B=20), the card tests'
# batches past it, and widths past the registers: K7's wide body from
# H=305 to H=660 (the TDAA classifier's H=600 among them) up to
# WIDE_MAX_BATCH rows, and one row and one width past it
WIDE = {(305, 1), (600, 1), (600, 5), (600, 16), (600, 48), (660, 1),
        (660, 48)}


@pytest.mark.parametrize("hidden,batch", [
    (300, 1), (300, 16), (300, 20), (300, 21), (300, 32), (300, 40),
    (300, 41), (300, 128),
    (37, 32), (8, 512), (304, 16), (305, 1), (600, 5), (600, 16),
    (600, 1), (600, 48), (600, 49), (660, 1), (660, 48), (660, 49),
    (661, 1), (300, 256), (300, 257), (304, 41), (37, 40), (37, 41),
    (300, 48), (300, 49), (300, 51), (300, 52), (300, 56), (300, 64),
    (37, 300), (304, 64)])
def test_rnn_body_and_its_chunks(hidden, batch):
    """Resident where H <= 304 and the batch needs at most the pass's
    RESIDENT_MAX_CHUNKS launches (the forward's 2: the measurements at B=32
    and B=48 on the card) of the grid that fits the 132 SMs, each launch
    2 * ceil(rows / 4) * ceil(H / 24) blocks; the chunks cover every row
    once, in order. Past that a forward at H <= 304 takes the tiled body
    from TILED_FROM rows on (K2 41, K7 52, where it beat the stepwise
    body; K2 up to H=304, K7 up to H=300, where its block fits the shared
    memory), and the stepwise one below. Past H=304 K7's forward takes
    the wide body where its 2 * ceil(H / 10) blocks fit the SMs (H <= 660)
    and B <= 48 (at H=660 also the last row a block's shared memory
    holds); K2's forward and every backward take the stepwise one."""
    rows = k.resident_chunk_rows(hidden)
    chunks = k.resident_chunks(batch, hidden)
    assert [r for r0, n in chunks for r in range(r0, r0 + n)] == list(
        range(batch))
    for _, n in chunks:
        assert n % 4 == 0 or n == chunks[-1][1]
        assert 2 * -(-n // 4) * -(-hidden // 24) <= k.H100_SMS
    want = ("resident" if hidden <= 304
            and len(chunks) <= k.RESIDENT_MAX_CHUNKS["forward"]
            else "stepwise")

    def forward(gates):
        tiled = (want == "stepwise" and hidden <= 304
                 and batch >= k.TILED_FROM[gates]
                 and (gates == 3 or hidden <= 300))
        return "tiled" if tiled else want
    assert k.rnn_body(hidden, batch, gates=3) == forward(3)
    if hidden <= 304:
        assert k.rnn_body(hidden, batch) == forward(4)
        back = ("resident" if 0 < len(chunks) <= k.RESIDENT_MAX_CHUNKS[
            "backward"] else "stepwise")
        assert k.rnn_body(hidden, batch, backward=True) == back
        assert k.rnn_body(hidden, batch, gates=3, backward=True) == back
    if hidden == 300:
        assert rows == 20
        assert want == ("resident" if batch <= 40 else "stepwise")
        assert forward(3) == ("resident" if batch <= 40 else "tiled")
        assert forward(4) == ("resident" if batch <= 40 else "stepwise"
                              if batch <= 51 else "tiled")
    if hidden > 304:
        assert want == "stepwise"
        assert k.rnn_body(hidden, batch) == (
            "wide" if (hidden, batch) in WIDE else "stepwise")
        assert k.rnn_body(hidden, batch, gates=3) == "stepwise"
        assert k.rnn_body(hidden, batch, backward=True) == "stepwise"
        fits = k.wide_smem_bytes(hidden, batch) <= k.SMEM_PER_BLOCK
        assert fits == ((hidden, batch) not in {(660, 49)})


@pytest.mark.parametrize("hidden,batch,directions,launches", [
    (300, 41, 2, [(0, 41)]), (300, 256, 2, [(0, 256)]),
    (300, 257, 2, [(0, 256), (256, 1)]), (300, 512, 1, [(0, 512)]),
    (300, 513, 1, [(0, 512), (512, 1)]), (8, 512, 2, [(0, 512)]),
    (37, 2112, 2, [(0, 2112)]), (304, 64, 2, [(0, 64)])])
def test_tiled_body_chunks_and_shared_memory(hidden, batch, directions,
                                             launches):
    """The tiled body's plan as the library walks it: one launch per chunk
    of tiled_chunk_rows rows, the most 32-row tiles whose blocks (D *
    ceil(H / 40) a tile, one an SM) fit the 132 SMs: 256 rows at H=300 for
    both directions, 512 for one, 2112 at H <= 40 (66 tiles of 2 blocks).
    A block holds U in ceil(H / 4) rows of 40 * gates + 1 float4 and 32
    rows of h at ceil(H / 4) | 1 float4 each: K2 fits the 232,448 bytes up
    to H=304, K7 up to H=300. The rule names the body where the resident
    one needs more than its 2 launches, K7's from B=52; at H=8 the resident
    body still holds B=512."""
    step = k.tiled_chunk_rows(hidden, directions)
    got = [(r, min(step, batch - r)) for r in range(0, batch, step)]
    assert got == launches
    assert k.tiled_groups(batch, directions) == directions * -(-batch // 32)
    kq = -(-hidden // 4)
    for gates in (3, 4):
        assert k.tiled_smem_bytes(hidden, gates) == 16 * (
            (40 * gates + 1) * kq + 32 * (kq | 1))
    assert k.tiled_smem_bytes(300, 3) == 183600
    assert k.tiled_smem_bytes(300, 4) == 231600
    fits = k.tiled_smem_bytes(hidden, 4) <= k.SMEM_PER_BLOCK
    assert fits == (hidden <= 300)
    assert k.tiled_smem_bytes(hidden, 3) <= k.SMEM_PER_BLOCK
    resident = len(k.resident_chunks(batch, hidden, directions)) <= 2
    assert resident == ((hidden, batch) == (8, 512))
    assert k.rnn_body(hidden, batch, directions, gates=3) == (
        "resident" if resident else "tiled")
    assert k.rnn_body(hidden, batch, directions) == (
        "resident" if resident else "tiled" if fits and batch >= 52
        else "stepwise")


@pytest.mark.parametrize("gates,first", [(3, 41), (4, 52)])
def test_tiled_body_starts_where_it_beat_the_stepwise_one(gates, first):
    """The tiled body's first batch, by gate count, where it was measured
    to beat the stepwise body at H=300: K2's at B=41, the first row past
    the resident body's two launches; K7's at B=52. Below it the forward
    keeps the body it had; no backward ever takes it."""
    assert k.TILED_FROM[gates] == first
    assert k.resident_chunk_rows(300) * k.RESIDENT_MAX_CHUNKS["forward"] == 40
    assert k.rnn_body(300, first, gates=gates) == "tiled"
    assert k.rnn_body(300, first - 1, gates=gates) == (
        "resident" if first == 41 else "stepwise")
    assert k.rnn_body(300, 256, gates=gates) == "tiled"
    assert k.rnn_body(300, 256, gates=gates, backward=True) == "stepwise"
    assert k.rnn_body(300, first, gates=gates,
                      clusters={19: 7, 36: 9}) == "tiled"


def test_rnn_body_takes_the_sm_count_from_its_argument():
    """At H=300 a 4-row tile of both directions is 26 blocks: 52 SMs hold
    two tiles (8 rows a launch), 25 SMs not one."""
    assert k.resident_chunk_rows(300, sms=52) == 8
    assert k.resident_chunks(10, 300, sms=52) == [(0, 8), (8, 2)]
    assert k.rnn_body(300, 8, sms=52) == "resident"
    assert k.resident_chunk_rows(300, sms=25) == 0
    assert k.rnn_body(300, 1, sms=25) == "stepwise"
    assert k.rnn_body(300, 16, sms=10_000) == "resident"


def test_wide_body_takes_the_sm_count_and_directions():
    """K7's wide body at H=600 needs 60 blocks a direction: both
    directions fit 120 SMs and not 119, one direction 60 and not 59; no SM
    count makes it take a backward, and a block that misses its shared
    memory (D = 1 past H=1248 at B=1, 4 * 10 f32 columns of U a row) is
    stepwise however many SMs there are."""
    assert k.rnn_body(600, 16, sms=120) == "wide"
    assert k.rnn_body(600, 16, sms=119) == "stepwise"
    assert k.rnn_body(600, 16, directions=1, sms=60) == "wide"
    assert k.rnn_body(600, 16, directions=1, sms=59) == "stepwise"
    assert k.rnn_body(600, 16, sms=10_000, backward=True) == "stepwise"
    assert k.rnn_body(1248, 1, directions=1) == "wide"
    assert k.rnn_body(1249, 1, directions=1, sms=10_000) == "stepwise"
    # U 96,000 bytes, the larger of 16 staged rows of 151 float4 and the
    # 2,048 float4 of partial sums
    assert k.wide_smem_bytes(600, 16) == 16 * (6000 + 16 * 151) == 134656
    assert k.wide_smem_bytes(600, 1) == 16 * (6000 + 2048)


# the occupancy answer of an NVIDIA H100 80GB HBM3 at H=300 (and any H from
# 289 to 304): cudaOccupancyMaxActiveClusters gives 7 clusters of 16 blocks
# of 19 units and 9 of 9 blocks of 36, for K2 and K7, f32 and bf16 alike
H100_CLUSTERS = {19: 7, 36: 9}


@pytest.mark.parametrize("hidden,batch,directions,units", [
    (300, 1, 2, 19), (300, 4, 2, 19), (300, 12, 2, 19), (300, 13, 2, 36),
    (300, 16, 2, 36), (300, 17, 2, 0), (300, 20, 2, 0), (300, 32, 2, 0),
    (300, 28, 1, 19), (300, 36, 1, 36), (300, 37, 1, 0), (304, 16, 2, 36),
    (305, 1, 2, 0), (600, 16, 2, 0)])
def test_rnn_body_names_the_cluster_body_where_its_clusters_all_fit(
        hidden, batch, directions, units):
    """A forward at H <= 304 takes the cluster body at the first tiling
    (19 units a block, then 36) whose D * ceil(B / 4) clusters the card
    holds at once, by the occupancy answer passed in: on an H100 16-block
    clusters up to 7 groups (B <= 12 both ways), 9-block ones up to 9
    (B=16, the training and TDAA serving batch). Where none fits, the
    forward keeps the body it has without the answer (resident, wide or
    stepwise); a backward never takes it."""
    assert k.cluster_units(hidden, batch, directions, H100_CLUSTERS) == units
    for gates in (3, 4):
        without = k.rnn_body(hidden, batch, directions, gates=gates)
        assert k.rnn_body(hidden, batch, directions, gates=gates,
                          clusters=H100_CLUSTERS) == (
            "cluster" if units else without)
        assert k.rnn_body(hidden, batch, directions, gates=gates,
                          backward=True, clusters=H100_CLUSTERS) == \
            k.rnn_body(hidden, batch, directions, gates=gates, backward=True)
    if (hidden, batch, directions) in {(300, 17, 2), (300, 20, 2),
                                       (300, 32, 2)}:
        assert without == "resident"
    if hidden == 600:
        assert k.rnn_body(600, batch, gates=4,
                          clusters=H100_CLUSTERS) == "wide"


def test_rnn_body_takes_the_occupancy_answer_from_its_argument():
    """The rule follows the answer it is given: none (the default) or one
    that holds fewer clusters than the launch's groups keeps the ticket body;
    past the bodies a batch stays stepwise whatever the answer."""
    assert k.rnn_body(300, 1) == "resident"
    assert k.rnn_body(300, 1, clusters={}) == "resident"
    assert k.rnn_body(300, 1, clusters={19: 1, 36: 1}) == "resident"
    assert k.cluster_units(300, 1, 2, {19: 2}) == 19
    assert k.cluster_units(300, 1, 2, {19: 1, 36: 2}) == 36
    assert k.rnn_body(300, 1, directions=1, clusters={19: 1}) == "cluster"
    assert k.rnn_body(300, 128, clusters=H100_CLUSTERS) == "tiled"
    assert k.rnn_body(300, 128, clusters={19: 64}) == "cluster"
    assert k.rnn_body(600, 64, gates=4, clusters=H100_CLUSTERS) == "stepwise"
    assert k.rnn_body(300, 16, backward=True,
                      clusters={19: 100, 36: 100}) == "resident"


def test_forward_clusters_past_the_registers_asks_no_card():
    """Past H=304 there is no cluster body, so the occupancy answer is
    empty without a query (here, on a machine without a card)."""
    assert k.forward_clusters(torch.device("cpu"), "lstm_fwd",
                              torch.float32, 600) == {}
    assert k.CLUSTER_UNITS == (19, 36)
