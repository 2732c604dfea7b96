"""The port's CUDA kernels (K1-K3) against their plain versions on the card.

These tests build the kernels with nvcc and launch them; they need an NVIDIA
GPU and skip elsewhere (the CUDA kernels have no interpret mode). The file
imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import types as ttypes
from repro_torch.kernels import iact_memo, ops, ref, taf_matmul

TAF_ATOL = IACT_ATOL = 1e-3
ATTN_ATOL = {torch.float32: 1e-4, torch.bfloat16: 0.05}


def _stableish(rng, m, k, noise=0.02):
    base = rng.randn(1, k).astype(np.float32)
    return np.tile(base, (m, 1)) + noise * rng.randn(m, k).astype(np.float32)


def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, hq, sq, d).astype(np.float32),
            rng.randn(b, hkv, skv, d).astype(np.float32),
            rng.randn(b, hkv, skv, d).astype(np.float32))


@pytest.mark.cuda
class TestOnCard:
    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no "
                        "interpret mode)")
        torch.backends.cuda.matmul.allow_tf32 = False

    def test_taf(self):
        rng = np.random.RandomState(0)
        x = torch.from_numpy(_stableish(rng, 256, 64)).cuda()
        w = torch.from_numpy(rng.randn(64, 128).astype(np.float32)).cuda()
        before = taf_matmul.COUNTER.launches
        work = taf_matmul.COUNTER.work()
        y, m = ops.taf_matmul(x, w, block_m=32, block_n=64,
                              history_size=3, prediction_size=4)
        yr, mr = ref.taf_matmul_ref(x, w, block_m=32, block_n=64,
                                    history_size=3, prediction_size=4,
                                    rsd_threshold=0.5)
        computed = taf_matmul.COUNTER.work() - work
        assert taf_matmul.COUNTER.launches == before + 1
        assert torch.equal(m, mr) and bool(m.any())
        assert computed == int((~m).sum())  # approximated tiles skip
        assert float((y - yr).abs().max()) <= TAF_ATOL

    def test_iact(self):
        rng = np.random.RandomState(1)
        distinct = rng.randn(4, 32).astype(np.float32)
        x = torch.from_numpy(np.repeat(distinct, 64, axis=0)).cuda()
        w1 = torch.from_numpy(rng.randn(32, 64).astype(np.float32)).cuda()
        w2 = torch.from_numpy(rng.randn(64, 16).astype(np.float32)).cuda()
        work = iact_memo.COUNTER.work()
        y, m = ops.iact_rowfn(x, w1, w2, block_rows=32, table_size=2)
        computed = iact_memo.COUNTER.work() - work
        yr, mr = ref.iact_rowfn_ref(x, w1, w2, block_rows=32, table_size=2,
                                    threshold=0.5)
        assert torch.equal(m, mr) and bool(m.any())
        assert computed == int((~m).sum())  # approximated blocks skip
        assert float((y - yr).abs().max()) <= IACT_ATOL

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_attention(self, dtype):
        q, k, v = (torch.from_numpy(a).cuda().to(dtype)
                   for a in _qkv(3, 2, 4, 2, 64, 128, 32))
        p = ttypes.PerforationParams(kind=ttypes.PerforationKind.FINI)
        o = ops.perforated_attention(q, k, v, block_q=32, block_kv=32,
                                     perfo=p, fraction=0.25)
        orf = ref.attention_ref(q, k, v, block_kv=32, perfo=p,
                                fraction=0.25)
        assert float((o.float() - orf.float()).abs().max()) <= \
            ATTN_ATOL[dtype]
