"""The ctypes bindings of the kernel library (dl4ss_tpu_torch/ops/cuda_lib.py)
against the C entry points they bind (dl4ss_tpu_torch/csrc/*.cu), on the
CPU: the library builds only on the card, where a binding that disagrees
with its entry point passes pointers as ints or shifts every argument."""

import re

import pytest

from dl4ss_tpu_torch.ops import cuda_lib

_ENTRY = re.compile(r'extern "C" (int|long long) dl4ss_(\w+)\(([^)]*)\)')


def _entry_points():
    """{name: (return type, parameter kinds)} from every source: "p" for a
    pointer, "i" for an int, as SIGNATURES and QUERIES write them."""
    found = {}
    for src in cuda_lib.SOURCES:
        text = (cuda_lib.CSRC / src).read_text()
        for ret, name, params in _ENTRY.findall(text):
            kinds = "".join("p" if "*" in p else "i" if p.split()[0] == "int"
                            else "?" for p in params.split(","))
            found[name] = (ret, kinds)
    return found


@pytest.mark.parametrize("name", sorted(cuda_lib.SIGNATURES))
def test_kernel_binding_matches_its_entry_point(name):
    """Each kernel entry point takes the binding's pointers and ints, then
    the stream, and returns an int error code."""
    ret, kinds = _entry_points()[name]
    assert ret == "int"
    assert kinds == cuda_lib.SIGNATURES[name] + "p", name


@pytest.mark.parametrize("name", sorted(cuda_lib.QUERIES))
def test_query_binding_matches_its_entry_point(name):
    ret, kinds = _entry_points()[name]
    assert (ret, kinds) == ("long long", cuda_lib.QUERIES[name])


def test_every_header_is_hashed():
    """A change to any header rebuilds the library: every .cuh in csrc/ is
    in HEADERS, which the build hash reads."""
    assert sorted(p.name for p in cuda_lib.CSRC.glob("*.cuh")) == sorted(
        cuda_lib.HEADERS)
    assert sorted(p.name for p in cuda_lib.CSRC.glob("*.cu")) == sorted(
        cuda_lib.SOURCES)


def test_inverse_fft_rule_matches_the_library():
    """`istft_body` (Python) and `istft_fft_takes` (the library's refusal)
    state one rule: the same ratio cap and frame lengths in both."""
    from dl4ss_tpu_torch.ops import stft_kernels as k
    text = (cuda_lib.CSRC / "istft_tile.cuh").read_text()
    cap = re.search(r"constexpr int ISTFT_FFT_MAX_RATIO = (\d+);", text)
    assert int(cap.group(1)) == k.ISTFT_FFT_MAX_RATIO
    assert (f"L >= {k.FFT_MIN_LENGTH} && L <= {k.FFT_MAX_LENGTH}"
            in text.split("inline bool istft_fft_takes")[1].split("}")[0])


def test_cluster_tilings_match_the_library():
    """`CLUSTER_UNITS` names the hidden units a block of the forward's two
    cluster tilings, as csrc sizes them: ClusterTiling19 and
    ClusterTiling36, in K2 and K7 alike."""
    from dl4ss_tpu_torch.ops import rnn_kernels as k
    for src in ("gru_fwd.cu", "lstm_fwd.cu"):
        text = (cuda_lib.CSRC / src).read_text()
        units = tuple(int(u) for u in re.findall(
            r"using ClusterTiling(\d+) = dl4ss::ResidentTiling<"
            r"\d+, \d+, \d+, \d+, \d+, \1>;", text))
        assert units == k.CLUSTER_UNITS, src


def test_tiled_constants_match_the_library():
    """The tiled body's rows a barrier group, units a block, body code and
    shared-memory limit, which `rnn_body` and `tiled_smem_bytes` follow, as
    csrc/rnn_fwd_tiled.cuh has them."""
    from dl4ss_tpu_torch.ops import rnn_kernels as k
    text = (cuda_lib.CSRC / "rnn_fwd_tiled.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr (?:int|size_t) {name} = (\d+);",
                             text).group(1))
    assert const("ROWS") == k.TILED_ROWS
    assert const("UNITS") == k.TILED_UNITS
    assert const("BODY_TILED") == k._BODY_CODES[k.BODY_TILED]
    assert const("SMEM_MAX") == k.SMEM_PER_BLOCK
    assert "rnn_fwd_tiled.cuh" in cuda_lib.HEADERS
