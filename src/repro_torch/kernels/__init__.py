"""repro_torch.kernels -- hand-written Hopper kernels and their wrappers.

`ops` holds the public wrappers; `ref` the plain PyTorch versions (the
oracles); `taf_matmul`, `iact_memo`, `perforated_attention` and
`perforated_matmul` bind the CUDA sources under `csrc/`, which `_build`
compiles at first use; `tuning` picks block shapes and keeps the tuning
cache that `ops` resolves None blocks from.
"""
