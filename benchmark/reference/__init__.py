"""The benchmark's plain reference: the separation models, their DSP and
their training steps in plain PyTorch, float32 (TF32 off on the card).

It follows the published description of the models and the precision that
each configuration file states, and imports nothing of the program under
test: no kernel, no plain version, no test helper. It reads the
configuration as the plain dict of the configuration file's `config` key.
"""
