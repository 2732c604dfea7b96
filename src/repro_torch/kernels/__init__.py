"""repro_torch.kernels -- hand-written Hopper kernels and their wrappers.

`ops` holds the public wrappers; `ref` the plain PyTorch versions (the
oracles); `taf_matmul`, `iact_memo` and `perforated_attention` bind the
CUDA sources under `csrc/`, which `_build` compiles at first use.
"""
