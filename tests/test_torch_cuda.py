"""The port's CUDA kernels (K1-K4) and the autotuner on the card.

These tests build the kernels with nvcc and launch them; they need an NVIDIA
GPU and skip elsewhere (the CUDA kernels have no interpret mode). The file
imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import types as ttypes
from repro_torch.core import perforation
from repro_torch.kernels import (iact_memo, ops, perforated_attention,
                                 perforated_matmul, ref, taf_matmul, tuning)

TAF_ATOL = IACT_ATOL = PMM_ATOL = 1e-3
PMM_FULL_ATOL = 1e-2  # sums of 3072 float32 products of order 1 (phase 3's)
ATTN_ATOL = {torch.float32: 1e-4, torch.bfloat16: 0.05}


def _stableish(rng, m, k, noise=0.02):
    base = rng.randn(1, k).astype(np.float32)
    return np.tile(base, (m, 1)) + noise * rng.randn(m, k).astype(np.float32)


def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, hq, sq, d).astype(np.float32),
            rng.randn(b, hkv, skv, d).astype(np.float32),
            rng.randn(b, hkv, skv, d).astype(np.float32))


def _iact_rows(n, din, br, kind, seed):
    """Rows for K3: "pairs" repeats a new point for two blocks (the second
    can hit); "alike" keeps every row near one point."""
    rng = np.random.RandomState(seed)
    if kind == "alike":
        return (np.tile(rng.randn(1, din), (n, 1))
                + 1e-4 * rng.randn(n, din)).astype(np.float32)
    distinct = rng.randn(max(n // (2 * br), 1), din)
    return (np.repeat(distinct, 2 * br, axis=0)[:n]
            + 0.001 * rng.randn(n, din)).astype(np.float32)


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

    @pytest.mark.parametrize("kind,arg,fraction,rescale", [
        (None, None, None, False),
        ("small", 2, None, True),
        ("large", 4, None, False),
        ("random", 0.25, None, True),
        ("ini", None, 0.5, True),
        ("fini", None, 0.25, False),
        ("random", None, 0.5, True),
        ("ini", None, 1.0, True),    # masked: every block dropped -> zeros
    ])
    def test_perforated_matmul(self, kind, arg, fraction, rescale):
        rng = np.random.RandomState(4)
        x = torch.from_numpy(rng.randn(128, 512).astype(np.float32)).cuda()
        w = torch.from_numpy(rng.randn(512, 96).astype(np.float32)).cuda()
        perfo = None
        if kind is not None:
            k = ttypes.PerforationKind(kind)
            perfo = (ttypes.PerforationParams(kind=k, skip=arg)
                     if kind in ("small", "large") else
                     ttypes.PerforationParams(kind=k, fraction=arg or 0.0))
        before = perforated_matmul.COUNTER.launches
        y = ops.perforated_matmul(x, w, block_m=64, block_n=32, block_k=32,
                                  perfo=perfo, fraction=fraction,
                                  rescale=rescale)
        yr = ref.perforated_matmul_ref(x, w, block_k=32, perfo=perfo,
                                       fraction=fraction, rescale=rescale)
        assert perforated_matmul.COUNTER.launches == before + 1
        assert float((y - yr).abs().max()) <= PMM_ATOL
        if fraction == 1.0:
            assert not bool(y.any())

    @pytest.mark.parametrize("kernel", ["taf_matmul", "iact_rowfn"])
    def test_largest_tuned_blocks(self, kernel):
        """The blocks the tuner picks at full width: K2 at block_m 512 and
        K3 at block_rows 512 with table_size 4."""
        rng = np.random.RandomState(6)
        if kernel == "taf_matmul":
            x = torch.from_numpy(_stableish(rng, 2048, 128)).cuda()
            w = torch.from_numpy(rng.randn(128, 1024).astype(
                np.float32)).cuda()
            kw = dict(block_m=512, block_n=512, history_size=2,
                      prediction_size=1, rsd_threshold=0.5)
            y, m = ops.taf_matmul(x, w, **kw)
            yr, mr = ref.taf_matmul_ref(x, w, **kw)
        else:
            distinct = rng.randn(2, 64).astype(np.float32)
            x = torch.from_numpy(np.repeat(distinct, 1024, axis=0)).cuda()
            w1 = torch.from_numpy(rng.randn(64, 128).astype(
                np.float32)).cuda()
            w2 = torch.from_numpy(rng.randn(128, 32).astype(
                np.float32)).cuda()
            kw = dict(block_rows=512, table_size=4, threshold=0.5)
            assert iact_memo.launchable((x.shape, w1.shape, w2.shape),
                                        {"block_rows": 512}) is None
            y, m = ops.iact_rowfn(x, w1, w2, **kw)
            yr, mr = ref.iact_rowfn_ref(x, w1, w2, **kw)
        assert torch.equal(m, mr) and bool(m.any())
        assert float((y - yr).abs().max()) <= TAF_ATOL

    @pytest.mark.parametrize("n,din,br,ts,thr,kind", [
        (128, 16, 32, 4, 0.5, "pairs"),
        (256, 32, 64, 2, 0.5, "pairs"),
        (64, 8, 16, 8, 0.5, "pairs"),
        (256, 8, 16, 2, 0.5, "pairs"),       # the table wraps
        (64, 16, 32, 4, 1e-9, "pairs"),      # every block computed
        (256, 32, 16, 2, 0.5, "alike"),      # only block 0 computed
        (4096, 2048, 16, 2, 0.05, "pairs"),  # the app's full width
    ])
    def test_iact_schedule_equals_plain(self, n, din, br, ts, thr, kind):
        x = torch.from_numpy(_iact_rows(n, din, br, kind, seed=n + din))
        mask, computed, src = iact_memo.schedule(x.cuda(), br, ts, thr)
        pm, pc, ps = iact_memo.schedule_plain(x, br, ts, thr)
        assert torch.equal(mask.cpu(), pm)
        assert torch.equal(computed.cpu(), pc)
        assert torch.equal(src.cpu(), ps)

    @pytest.mark.parametrize("kind,thr", [("alike", 0.5), ("pairs", 1e-9)])
    def test_iact_list_empty_after_block_0_and_full(self, kind, thr):
        rng = np.random.RandomState(8)
        x = torch.from_numpy(_iact_rows(256, 32, 16, kind, seed=8)).cuda()
        w1 = torch.from_numpy(rng.randn(32, 64).astype(np.float32)).cuda()
        w2 = torch.from_numpy(rng.randn(64, 16).astype(np.float32)).cuda()
        work = iact_memo.COUNTER.work()
        y, m = ops.iact_rowfn(x, w1, w2, block_rows=16, table_size=2,
                              threshold=thr)
        computed = iact_memo.COUNTER.work() - work
        yr, mr = ref.iact_rowfn_ref(x, w1, w2, block_rows=16, table_size=2,
                                    threshold=thr)
        assert torch.equal(m, mr)
        assert computed == (1 if kind == "alike" else 16)
        assert float((y - yr).abs().max()) <= IACT_ATOL

    @pytest.mark.parametrize("m,k,n,bm,bn", [
        (256, 64, 128, 32, 32),     # four column blocks
        (256, 64, 128, 16, 128),    # block_n = N, the app's shape
        (2048, 256, 1024, 512, 64),  # the tuned 512 / 64: 16 column blocks
        (512, 100, 96, 8, 48),      # K off the chunk, 16-column slices of 48
    ])
    def test_taf_block_shapes(self, m, k, n, bm, bn):
        rng = np.random.RandomState(9)
        x = torch.from_numpy(_stableish(rng, m, k)).cuda()
        w = torch.from_numpy(rng.randn(k, n).astype(np.float32)).cuda()
        kw = dict(block_m=bm, block_n=bn, history_size=2, prediction_size=3,
                  rsd_threshold=0.5)
        work = taf_matmul.COUNTER.work()
        y, mk = ops.taf_matmul(x, w, **kw)
        computed = taf_matmul.COUNTER.work() - work
        yr, mr = ref.taf_matmul_ref(x, w, **kw)
        assert torch.equal(mk, mr) and bool(mk.any())
        assert computed == int((~mk).sum())
        assert float((y - yr).abs().max()) <= TAF_ATOL

    def test_repeated_calls_are_identical(self):
        rng = np.random.RandomState(10)
        x = torch.from_numpy(_stableish(rng, 1024, 256)).cuda()
        w = torch.from_numpy(rng.randn(256, 512).astype(np.float32)).cuda()
        a = torch.from_numpy(_iact_rows(1024, 64, 16, "pairs", 10)).cuda()
        w1 = torch.from_numpy(rng.randn(64, 128).astype(np.float32)).cuda()
        w2 = torch.from_numpy(rng.randn(128, 64).astype(np.float32)).cuda()
        runs = [(ops.taf_matmul(x, w, block_m=16, block_n=512,
                                history_size=2, prediction_size=4,
                                rsd_threshold=0.2),
                 ops.iact_rowfn(a, w1, w2, block_rows=16, table_size=2,
                                threshold=0.5))
                for _ in range(3)]
        for (taf, iact) in runs[1:]:
            for got, want in zip(taf + iact, runs[0][0] + runs[0][1]):
                assert torch.equal(got, want)

    def test_one_call_is_one_k2_launch_and_four_k3_launches(self):
        from repro_torch.benchmarks import kernel_profile
        rng = np.random.RandomState(11)
        x = torch.from_numpy(_stableish(rng, 512, 64)).cuda()
        w = torch.from_numpy(rng.randn(64, 128).astype(np.float32)).cuda()
        a = torch.from_numpy(_iact_rows(512, 32, 16, "pairs", 11)).cuda()
        w1 = torch.from_numpy(rng.randn(32, 64).astype(np.float32)).cuda()
        w2 = torch.from_numpy(rng.randn(64, 32).astype(np.float32)).cuda()
        dev = x.device
        for bm in (16, 64):
            assert kernel_profile.launches_per_call(
                lambda: ops.taf_matmul(x, w, block_m=bm, block_n=128),
                taf_matmul.CUDA_KERNELS, dev) == 1
        for br in (16, 128):
            assert kernel_profile.launches_per_call(
                lambda: ops.iact_rowfn(a, w1, w2, block_rows=br),
                iact_memo.CUDA_KERNELS, dev) == 4

    @pytest.mark.parametrize("bm", perforated_matmul.TILE_SIDES)
    @pytest.mark.parametrize("bn", perforated_matmul.TILE_SIDES)
    def test_perforated_matmul_tiles_at_full_width_k(self, bm, bn):
        """Every CTA tile, structural and masked, rescale on and off, at
        K4's full-width contraction length; a fraction that drops every
        block gives zeros; the device tally counts the live blocks."""
        rng = np.random.RandomState(12)
        x = torch.from_numpy(rng.randn(256, 6144).astype(np.float32)).cuda()
        w = torch.from_numpy(rng.randn(6144, 128).astype(np.float32)).cuda()
        P, K = ttypes.PerforationParams, ttypes.PerforationKind
        nk = 6144 // 128
        for perfo, fraction, rescale in (
                (P(kind=K.SMALL, skip=2), None, False),
                (None, None, True),
                (P(kind=K.LARGE, skip=4), None, True),
                (P(kind=K.FINI), 0.5, True),
                (P(kind=K.RANDOM), 0.3, False),
                (P(kind=K.INI), 1.0, True)):
            if fraction is not None:
                live = int(perforation.traced_execute_mask(
                    nk, perfo, fraction).sum())
            else:
                live = nk if perfo is None else len(
                    perforation.kept_indices(nk, perfo))
            work = perforated_matmul.COUNTER.work()
            y = ops.perforated_matmul(x, w, block_m=bm, block_n=bn,
                                      block_k=128, perfo=perfo,
                                      fraction=fraction, rescale=rescale)
            assert perforated_matmul.COUNTER.work() - work == live
            yr = ref.perforated_matmul_ref(x, w, block_k=128, perfo=perfo,
                                           fraction=fraction,
                                           rescale=rescale)
            assert float((y - yr).abs().max()) <= PMM_FULL_ATOL
            if live == 0:
                assert not bool(y.any())

    @pytest.mark.parametrize("d", perforated_attention.HEAD_DIMS)
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_attention_head_dims(self, d, dtype):
        """Every instantiated D in both types: GQA, Sq < Skv, non-causal,
        masked and structural perforation, every block_q, and rows whose
        only keys lie in a dropped block (output 0)."""
        P, K = ttypes.PerforationParams, ttypes.PerforationKind
        cases = [  # (hq, hkv, sq, skv, block_q, block_kv, causal, perfo, frac)
            (4, 2, 128, 128, 32, 32, True, None, None),
            (4, 1, 64, 128, 16, 32, True, P(kind=K.FINI), 0.5),
            (2, 2, 128, 256, 64, 64, False, P(kind=K.SMALL, skip=2), None),
            (2, 1, 128, 128, 128, 32, True, P(kind=K.INI, fraction=0.25),
             None),
            (4, 4, 64, 64, 32, 32, True, P(kind=K.RANDOM), 0.3),
        ]
        for i, (hq, hkv, sq, skv, bq, bkv, causal, perfo, frac) in \
                enumerate(cases):
            q, k, v = (torch.from_numpy(a).cuda().to(dtype)
                       for a in _qkv(20 + i, 2, hq, hkv, sq, skv, d))
            o = ops.perforated_attention(q, k, v, block_q=bq, block_kv=bkv,
                                         perfo=perfo, fraction=frac,
                                         causal=causal)
            orf = ref.attention_ref(q, k, v, block_kv=bkv, perfo=perfo,
                                    fraction=frac, causal=causal)
            assert o.dtype == dtype
            assert float((o.float() - orf.float()).abs().max()) <= \
                ATTN_ATOL[dtype], (i, d, dtype)
            if perfo is not None and perfo.kind == K.INI:
                # block 0 dropped: rows 0..bkv-1 see no key
                assert not bool(o[:, :, :bkv].any())

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_k1_k4_repeated_calls_are_identical(self, dtype):
        rng = np.random.RandomState(13)
        q, k, v = (torch.from_numpy(a).cuda().to(dtype)
                   for a in _qkv(13, 1, 4, 2, 256, 256, 128))
        x = torch.from_numpy(rng.randn(256, 1024).astype(np.float32)).cuda()
        w = torch.from_numpy(rng.randn(1024, 256).astype(np.float32)).cuda()
        fini = ttypes.PerforationParams(kind=ttypes.PerforationKind.FINI)
        runs = [(ops.perforated_attention(q, k, v, block_q=32, block_kv=32,
                                          perfo=fini, fraction=0.5),
                 ops.perforated_matmul(x, w, block_m=128, block_n=128,
                                       block_k=128, perfo=fini,
                                       fraction=0.25, rescale=True))
                for _ in range(3)]
        for o, y in runs[1:]:
            assert torch.equal(o, runs[0][0]) and torch.equal(y, runs[0][1])

    def test_one_call_is_one_k1_launch_and_one_k4_launch(self):
        from repro_torch.benchmarks import kernel_profile
        q, k, v = (torch.from_numpy(a).cuda()
                   for a in _qkv(14, 1, 4, 4, 128, 128, 64))
        rng = np.random.RandomState(14)
        x = torch.from_numpy(rng.randn(256, 512).astype(np.float32)).cuda()
        w = torch.from_numpy(rng.randn(512, 256).astype(np.float32)).cuda()
        fini = ttypes.PerforationParams(kind=ttypes.PerforationKind.FINI)
        for bq in (32, 64):
            assert kernel_profile.launches_per_call(
                lambda: ops.perforated_attention(
                    q, k, v, block_q=bq, block_kv=32, perfo=fini,
                    fraction=0.5),
                perforated_attention.CUDA_KERNELS, q.device) == 1
        for bm in (64, 128):
            assert kernel_profile.launches_per_call(
                lambda: ops.perforated_matmul(
                    x, w, block_m=bm, block_n=128, block_k=128),
                perforated_matmul.CUDA_KERNELS, x.device) == 1

    def test_autotune_launches_every_candidate(self):
        rng = np.random.RandomState(5)
        x = torch.from_numpy(rng.randn(256, 256).astype(np.float32)).cuda()
        w = torch.from_numpy(rng.randn(256, 256).astype(np.float32)).cuda()
        before = perforated_matmul.COUNTER.launches
        cache = tuning.TuningCache()
        cfg = tuning.autotune("perforated_matmul", x, w, cache=cache,
                              max_measure=3, warmup=1, repeats=2)
        (entry,) = cache.entries.values()
        # the top 3 and the fallback 128/128/128 where it is not among them
        assert entry["measured"] in (3, 4)
        assert perforated_matmul.COUNTER.launches - before == \
            3 * entry["measured"]
        shapes = tuning.operand_shapes((x, w))
        assert tuning.validate_config("perforated_matmul", shapes,
                                      cfg) is None
        assert tuning.current_substrate(x.device) == "cuda"


@pytest.mark.cuda
class TestTechniquesOnCard:
    """The technique state machines, the five HPC apps and `ApproxRegion` on
    the "cuda" substrate, on the card."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU")
        torch.backends.cuda.matmul.allow_tf32 = False

    @staticmethod
    def _bs(n=4096, steps=16, device="cuda"):
        from repro_torch.apps import blackscholes
        return torch.from_numpy(blackscholes.gen_inputs(n, steps)).to(
            device), blackscholes.bs_price

    @pytest.mark.parametrize("tech", ["taf", "iact"])
    @pytest.mark.parametrize("level", [ttypes.Level.ELEMENT,
                                       ttypes.Level.TILE])
    def test_run_sequence_makes_no_sync(self, tech, level):
        from repro_torch.core import iact, taf
        xs, fn = self._bs()
        if tech == "taf":
            run = lambda x: taf.run_sequence(  # noqa: E731
                ttypes.TAFParams(2, 8, 0.5), x, fn, level)
        else:
            run = lambda x: iact.run_sequence(  # noqa: E731
                ttypes.IACTParams(2, 0.3, 0), x, fn, level)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ys, _, frac = run(xs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ys_c, _, frac_c = run(xs.cpu())
        assert float(frac) > 0
        assert abs(float(frac) - float(frac_c)) <= 0.005
        np.testing.assert_allclose(ys.cpu().numpy(), ys_c.numpy(),
                                   rtol=1e-4, atol=1e-3)

    def test_taf_block_reads_equal_accurate_steps(self):
        from repro_torch.core import taf
        from repro_torch.obs import metrics
        xs, fn = self._bs(steps=48)
        before = metrics.host_reads()
        ys, _, frac = taf.run_sequence(ttypes.TAFParams(2, 8, 0.5), xs, fn,
                                       ttypes.Level.BLOCK)
        reads = metrics.host_reads() - before
        accurate = round((1.0 - float(frac)) * xs.shape[0])
        assert 0 < accurate < xs.shape[0]
        assert reads == accurate
        ys_c, _, frac_c = taf.run_sequence(ttypes.TAFParams(2, 8, 0.5),
                                           xs.cpu(), fn, ttypes.Level.BLOCK)
        assert float(frac) == float(frac_c)

    def test_iact_block_reads_are_bounded(self):
        from repro_torch.core import iact
        from repro_torch.obs import metrics
        xs, fn = self._bs(steps=33)
        steps = xs.shape[0]
        same = xs[:1].expand_as(xs).contiguous()
        # every step after the first approximates: one read per chunk, the
        # chunks 1, 2, 4, ... steps long
        before = metrics.host_reads()
        _, _, frac = iact.run_sequence(ttypes.IACTParams(2, 0.3, 0), same,
                                       fn, ttypes.Level.BLOCK)
        reads = metrics.host_reads() - before
        assert round(float(frac) * steps) == steps - 1
        assert reads <= int(np.ceil(np.log2(steps))) + 1
        # nothing approximates: one read before each accurate step but the
        # first
        before = metrics.host_reads()
        _, _, frac = iact.run_sequence(ttypes.IACTParams(2, 0.0, 0), xs, fn,
                                       ttypes.Level.BLOCK)
        assert float(frac) == 0.0
        assert metrics.host_reads() - before == steps - 1

    @pytest.mark.parametrize("name", ["blackscholes", "binomial_options",
                                      "kmeans", "lavamd", "minife_cg"])
    def test_app_on_card_equals_cpu(self, name):
        import importlib
        from repro_torch.core import harness
        mod = importlib.import_module(f"repro_torch.apps.{name}")
        spec = ttypes.ApproxSpec(ttypes.Technique.TAF, ttypes.Level.ELEMENT,
                                 taf=ttypes.TAFParams(
                                     3 if name == "minife_cg" else 2, 8,
                                     0.5))
        card = mod.make_app().run(spec)
        cpu = mod.make_app(device="cpu").run(spec)
        assert abs(card.approx_fraction - cpu.approx_fraction) <= 0.005
        if name == "kmeans":
            assert harness.mcr(cpu.qoi, card.qoi) <= 0.005
        else:
            np.testing.assert_allclose(card.qoi, cpu.qoi, rtol=1e-4,
                                       atol=1e-3)

    def test_region_on_cuda_launches_k2_and_k3(self):
        from repro_torch.core import ApproxRegion, hierarchy, substrate
        rng = np.random.RandomState(9)
        base = rng.randn(8, 1, 64)[[0, 0, 1, 1, 2, 2, 3, 3]]
        x = torch.from_numpy((np.repeat(base, 32, axis=1).reshape(256, 64)
                              + 0.01 * rng.randn(256, 64)).astype(
                                  np.float32)).cuda()
        w = torch.from_numpy((rng.randn(64, 64) / 8).astype(
            np.float32)).cuda()
        w2 = torch.from_numpy((rng.randn(128, 64) / 11).astype(
            np.float32)).cuda()
        w1 = torch.from_numpy((rng.randn(64, 128) / 8).astype(
            np.float32)).cuda()
        T, L = ttypes.Technique, ttypes.Level
        taf_spec = ttypes.ApproxSpec(T.TAF, L.BLOCK,
                                     taf=ttypes.TAFParams(2, 4, 0.2))
        iact_spec = ttypes.ApproxSpec(T.IACT, L.BLOCK,
                                      iact=ttypes.IACTParams(2, 0.5, 1))
        cases = [
            (taf_spec, taf_matmul.COUNTER,
             lambda xx, **kw: substrate.taf_matmul_region(
                 xx, w, taf_spec, block_m=32, block_n=64,
                 rsd_threshold=kw.get("rsd_threshold"))),
            (iact_spec, iact_memo.COUNTER,
             lambda xx, **kw: substrate.iact_ffn_region(
                 xx, w1, w2, iact_spec, block_rows=32,
                 threshold=kw.get("threshold"))),
        ]
        for spec, counter, impl in cases:
            region = ApproxRegion(spec, None, n_elements=256,
                                  substrate="cuda", cuda_impl=impl)
            before = counter.launches
            ys, frac = region.run(x)
            assert counter.launches > before
            y_direct, mask = impl(x)
            assert torch.equal(ys, y_direct)
            assert float(frac) == float(hierarchy.fraction(mask))


@pytest.mark.cuda
class TestSixthSliceOnCard:
    """`perforation.perforated_sum`, `perforated_loop`'s carries and the
    quickstart's K2 section on the card."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU")
        torch.backends.cuda.matmul.allow_tf32 = False

    @pytest.mark.parametrize("kind,arg", [("small", 4), ("large", 3),
                                          ("ini", 0.25), ("fini", 0.5),
                                          ("random", 0.3)])
    @pytest.mark.parametrize("rescale", [True, False])
    def test_perforated_sum_stays_on_the_card(self, kind, arg, rescale):
        k = ttypes.PerforationKind(kind)
        p = (ttypes.PerforationParams(kind=k, skip=arg) if isinstance(arg, int)
             else ttypes.PerforationParams(kind=k, fraction=arg))
        xs = torch.from_numpy(np.random.RandomState(4).standard_normal(
            (64, 1000, 3)).astype(np.float32))
        for axis in (0, 1):
            got = perforation.perforated_sum(xs.cuda(), p, axis=axis,
                                             rescale=rescale)
            want = perforation.perforated_sum(xs, p, axis=axis,
                                              rescale=rescale)
            assert got.device.type == "cuda"
            # float32 sums of up to 1000 terms of order 1, in the card's
            # and the CPU's orders
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-4)

    def test_perforated_loop_dict_carry_masks_on_the_card(self):
        from repro_torch.core import ApproxSpec, Technique, perforated_loop
        spec = ApproxSpec(Technique.PERFORATION,
                          perforation=ttypes.PerforationParams(
                              kind=ttypes.PerforationKind.FINI,
                              fraction=0.5))
        dev = torch.device("cuda")
        out, frac = perforated_loop(
            spec, 8, lambda i, c: {"a": c["a"] + 1.0},
            {"a": torch.zeros((), device=dev)},
            fraction=0.5)  # a float knob: the mask follows the carry
        assert out["a"].device.type == "cuda" and float(out["a"]) == 4.0
        assert frac.device.type == "cuda" and float(frac) == 0.5

    def test_quickstart_k2_section(self, capsys):
        from repro_torch import quickstart
        before = taf_matmul.COUNTER.launches
        out = quickstart.main(device="cuda")
        assert taf_matmul.COUNTER.launches > before
        assert out["k2_matches"]
        cpu = quickstart.main(device="cpu")
        assert out["k2_approx_blocks"] == cpu["k2_approx_blocks"]
        assert out["taf_fraction"] == cpu["taf_fraction"]
        assert out["best"]["spec"] == cpu["best"]["spec"]
        assert "taf_matmul kernel == oracle: True" in capsys.readouterr().out


@pytest.mark.cuda
class TestLanesOnCard:
    """The lane-grid form of K1-K3: one wrapper call for L knobs, each lane
    against its plain version, masks equal, at the main path's full width
    (Qwen3-1.7B: seq 4096, d 2048, 16 heads of 128, d_h 6144)."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no "
                        "interpret mode)")
        torch.backends.cuda.matmul.allow_tf32 = False

    @staticmethod
    def _stack(lanes, values):
        return torch.tensor(values[:lanes], dtype=torch.float32,
                            device="cuda")

    @pytest.mark.parametrize("lanes", [1, 3, 4])
    def test_taf_lanes_at_full_width(self, lanes):
        rng = np.random.RandomState(20 + lanes)
        x = torch.from_numpy(_stableish(rng, 4096, 2048, 0.05)).cuda()
        w = torch.from_numpy((rng.randn(2048, 2048) / np.sqrt(2048))
                             .astype(np.float32)).cuda()
        th = self._stack(lanes, [0.02, 0.0005, 0.2, 0.002])
        kw = dict(block_m=16, block_n=2048, history_size=2,
                  prediction_size=4)
        before = taf_matmul.COUNTER.launches
        work = taf_matmul.COUNTER.work()
        y, m = ops.taf_matmul(x, w, rsd_threshold=th, **kw)
        computed = taf_matmul.COUNTER.work() - work
        assert taf_matmul.COUNTER.launches == before + 1
        yr, mr = ref.taf_matmul_lanes_ref(x, w, rsd_threshold=th, **kw)
        assert tuple(m.shape) == (lanes, 256, 1)
        # lanes that share x and w share each computed product
        assert computed == int((~m).any(0).sum())
        assert torch.equal(m, mr)
        assert float((y - yr).abs().max()) <= TAF_ATOL
        for lane in range(lanes):
            y1, m1 = ops.taf_matmul(x, w, rsd_threshold=th[lane], **kw)
            assert torch.equal(m1, m[lane]) and torch.equal(y1, y[lane])

    def test_taf_lane_set_over_many_column_blocks(self):
        rng = np.random.RandomState(32)
        x = torch.from_numpy(_stableish(rng, 1024, 512, 0.05)).cuda()
        w = torch.from_numpy(rng.randn(512, 2048).astype(np.float32)).cuda()
        th = self._stack(4, [0.001, 0.02, 0.1, 1.0])
        kw = dict(block_m=32, block_n=64, history_size=3, prediction_size=2)
        y, m = ops.taf_matmul(x, w, rsd_threshold=th, **kw)
        yr, mr = ref.taf_matmul_lanes_ref(x, w, rsd_threshold=th, **kw)
        assert torch.equal(m, mr) and bool(m.any()) and not bool(m.all())
        assert float((y - yr).abs().max()) <= TAF_ATOL

    def test_taf_lanes_take_units_in_rounds(self):
        """L = 4 lanes of 128 column blocks each: 512 (lane, column block)
        units for at most 132 co-resident teams of one CTA."""
        rng = np.random.RandomState(31)
        x = torch.from_numpy(np.stack([_stableish(rng, 1024, 256, 0.05)
                                       for _ in range(4)])).cuda()
        w = torch.from_numpy(rng.randn(256, 2048).astype(np.float32)).cuda()
        th = self._stack(4, [0.01, 0.05, 0.2, 1.0])
        kw = dict(block_m=16, block_n=16, history_size=2, prediction_size=4)
        work = taf_matmul.COUNTER.work()
        y, m = ops.taf_matmul(x, w, rsd_threshold=th, **kw)
        computed = taf_matmul.COUNTER.work() - work
        yr, mr = ref.taf_matmul_lanes_ref(x, w, rsd_threshold=th, **kw)
        assert torch.equal(m, mr) and bool(m.any()) and not bool(m.all())
        assert computed == int((~m).sum())
        assert float((y - yr).abs().max()) <= TAF_ATOL

    @pytest.mark.parametrize("lanes", [1, 3, 4])
    def test_iact_lanes_at_full_width(self, lanes):
        x = torch.from_numpy(_iact_rows(4096, 2048, 16, "pairs", 7)).cuda()
        rng = np.random.RandomState(8)
        w1 = torch.from_numpy((rng.randn(2048, 6144) / np.sqrt(2048))
                              .astype(np.float32)).cuda()
        w2 = torch.from_numpy((rng.randn(6144, 2048) / np.sqrt(6144))
                              .astype(np.float32)).cuda()
        th = self._stack(lanes, [0.5, 1e-9, 0.05, 5.0])
        kw = dict(block_rows=16, table_size=2)
        before = iact_memo.COUNTER.launches
        work = iact_memo.COUNTER.work()
        y, m = ops.iact_rowfn(x, w1, w2, threshold=th, **kw)
        computed = iact_memo.COUNTER.work() - work
        assert iact_memo.COUNTER.launches == before + 1
        yr, mr = ref.iact_rowfn_lanes_ref(x, w1, w2, threshold=th, **kw)
        assert tuple(m.shape) == (lanes, 256)
        assert torch.equal(m, mr) and computed == int((~m).sum())
        assert float((y - yr).abs().max()) <= IACT_ATOL
        for lane in range(lanes):
            y1, m1 = ops.iact_rowfn(x, w1, w2, threshold=th[lane], **kw)
            assert torch.equal(m1, m[lane]) and torch.equal(y1, y[lane])

    def test_iact_lanes_with_stacked_rows(self):
        """Each lane its own rows: masks equal to the sequential table's,
        values to the kernel's composition in plain PyTorch (the same
        float64 distance sums, so the same nearest slot where rows "alike"
        are all nearly equidistant)."""
        xs = torch.stack([torch.from_numpy(_iact_rows(512, 256, 16, kind, s))
                          for kind, s in (("pairs", 1), ("alike", 2),
                                          ("pairs", 3))]).cuda()
        rng = np.random.RandomState(4)
        w1 = torch.from_numpy((rng.randn(256, 512) / 16.0)
                              .astype(np.float32)).cuda()
        w2 = torch.from_numpy((rng.randn(512, 128) / np.sqrt(512))
                              .astype(np.float32)).cuda()
        th = self._stack(3, [0.5, 0.5, 1e-9])
        kw = dict(block_rows=16, table_size=4)
        y, m = ops.iact_rowfn(xs, w1, w2, threshold=th, **kw)
        _, mr = ref.iact_rowfn_lanes_ref(xs, w1, w2, threshold=th, **kw)
        assert torch.equal(m, mr) and bool(m.any())
        for lane in range(3):
            yp, mp = iact_memo.iact_rowfn_plain(xs[lane], w1, w2,
                                                threshold=th[lane], **kw)
            assert torch.equal(mp, m[lane])
            assert float((y[lane] - yp).abs().max()) <= IACT_ATOL

    @pytest.mark.parametrize("lanes", [1, 3, 4])
    def test_attention_lanes_at_full_width(self, lanes):
        q = torch.from_numpy(np.random.RandomState(5).randn(
            1, 16, 4096, 128).astype(np.float32)).cuda()
        p = ttypes.PerforationParams(kind=ttypes.PerforationKind.FINI)
        fr = self._stack(lanes, [0.5, 0.0, 0.25, 0.75])
        kw = dict(block_q=32, block_kv=32, perfo=p)
        before = perforated_attention.COUNTER.launches
        o = ops.perforated_attention(q, q, q, fraction=fr, **kw)
        assert perforated_attention.COUNTER.launches == before + 1
        assert tuple(o.shape) == (lanes, 1, 16, 4096, 128)
        for lane in range(lanes):
            orf = ref.attention_ref(q, q, q, block_kv=32, perfo=p,
                                    fraction=fr[lane])
            assert float((o[lane] - orf).abs().max()) <= \
                ATTN_ATOL[torch.float32]
            o1 = ops.perforated_attention(q, q, q, fraction=fr[lane], **kw)
            assert torch.equal(o1, o[lane])

    def test_attention_lanes_with_stacked_operands(self):
        rng = np.random.RandomState(6)
        q, k, v = (torch.from_numpy(rng.randn(3, 2, 4, 256, 64)
                                    .astype(np.float32)).cuda()
                   for _ in range(3))
        p = ttypes.PerforationParams(kind=ttypes.PerforationKind.RANDOM)
        fr = self._stack(3, [0.1, 0.5, 0.9])
        o = ops.perforated_attention(q, k[:, :, :2].contiguous(),
                                     v[:, :, :2].contiguous(), block_q=64,
                                     block_kv=64, perfo=p, fraction=fr)
        orf = ref.attention_lanes_ref(q, k[:, :, :2], v[:, :, :2],
                                      block_kv=64, perfo=p, fraction=fr)
        assert float((o - orf).abs().max()) <= ATTN_ATOL[torch.float32]

    def test_ffn_group_is_one_call_per_kernel(self):
        from repro_torch.apps import approx_ffn
        from repro_torch.benchmarks.approx_ffn_sweep import grid
        from repro_torch.core import batching
        app = approx_ffn.make_app(device="cuda")
        specs = grid()
        groups, _ = batching.group_specs(specs)
        ops.reset_counts()
        app.run_batch(specs)
        # each group: a warm-up call and a timed call, one launch chain each
        n = {t: 2 * sum(1 for k in groups if k[0] == t)
             for t in ttypes.Technique}
        got = ops.launch_counts()
        assert got["taf_matmul"] == n[ttypes.Technique.TAF]
        assert got["iact_rowfn"] == n[ttypes.Technique.IACT]
        # + 2 serial runs (warm-up, timed) of each skip-driven spec: none in
        # this grid
        assert got["perforated_attention"] == n[ttypes.Technique.PERFORATION]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return None if tree is None else tree.to(dev)


@pytest.mark.cuda
class TestServingOnCard:
    """The dense LM, decode-time TAF and the serving engine on the card
    against the port on the CPU, on the same weights (the CPU init moved to
    the card)."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU")
        torch.backends.cuda.matmul.allow_tf32 = False

    @staticmethod
    def _models(cdt="float32", taf=None, arch="qwen3-1.7b"):
        import dataclasses
        from repro_torch.configs import get_smoke_config
        from repro_torch.models import build
        cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype=cdt)
        if taf is not None:
            cfg = dataclasses.replace(cfg, approx_decode=ttypes.ApproxSpec(
                ttypes.Technique.TAF, ttypes.Level.BLOCK,
                taf=ttypes.TAFParams(2, 4, taf)))
        cpu = build(cfg, device="cpu")
        params = cpu.init(torch.Generator().manual_seed(0))
        return cfg, cpu, params, build(cfg, device="cuda"), \
            _to(params, torch.device("cuda"))

    @pytest.mark.parametrize("cdt,tol", [("float32", 1e-4),
                                         ("bfloat16", 0.02)])
    def test_prefill_and_decode_match_the_cpu(self, cdt, tol):
        cfg, cpu, p, card, pc = self._models(cdt)
        toks = np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 20))
        la, ca = cpu.prefill(p, {"tokens": toks[:, :16], "max_len": 20})
        lb, cb = card.prefill(pc, {"tokens": toks[:, :16], "max_len": 20})
        scale = float(la.abs().max())
        assert float((la - lb.cpu()).abs().max()) / scale < tol
        for t in range(3):
            tok = torch.as_tensor(toks[:, 16 + t])
            la, ca = cpu.decode_step(p, ca, tok, 16 + t)
            lb, cb = card.decode_step(pc, cb, tok.cuda(), 16 + t)
            assert float((la - lb.cpu()).abs().max()) / scale < tol

    def test_taf_decisions_match_the_cpu(self):
        from repro_torch.obs import metrics as obs_metrics
        cfg, cpu, p, card, pc = self._models(taf=50.0, arch="deepseek-7b")
        toks = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 8))
        _, ca = cpu.prefill(p, {"tokens": toks, "max_len": 24})
        _, cb = card.prefill(pc, {"tokens": toks, "max_len": 24})
        tok = torch.as_tensor(toks[:, -1])
        skipped = 0
        for t in range(12):
            la, ca = cpu.decode_step(p, ca, tok, 8 + t)
            reads = obs_metrics.host_reads()
            lb, cb = card.decode_step(pc, cb, tok.cuda(), 8 + t)
            assert obs_metrics.host_reads() - reads == 1
            assert torch.equal(ca["taf"]["remaining"],
                               cb["taf"]["remaining"].cpu())
            skipped += int((ca["taf"]["remaining"] > 0).sum())
            tok = torch.argmax(la, -1).to(torch.int32)
        assert skipped > 0

    def test_engine_streams_match_the_cpu(self):
        from repro_torch.serving import Request, ServingEngine
        cfg, cpu, p, card, pc = self._models(taf=50.0)
        outs = []
        for model, params in ((cpu, p), (card, pc)):
            eng = ServingEngine(model, params, slots=3, max_len=48,
                                prompt_len=8)
            rng = np.random.RandomState(0)
            reqs = [Request(uid=i, prompt=rng.randint(0, cfg.vocab_size, 8)
                            .astype(np.int32), max_new_tokens=5 + i)
                    for i in range(7)]
            for r in reqs:
                eng.submit(r)
            s = eng.run_until_drained()
            outs.append(([r.output for r in reqs],
                         (s.ticks, s.tokens_out, s.taf_skipped, s.taf_total)))
        assert outs[0] == outs[1]


ZOO = ("olmoe-1b-7b", "deepseek-v3-671b", "zamba2-7b", "rwkv6-1.6b",
       "whisper-large-v3", "pixtral-12b", "starcoder2-3b", "qwen1.5-4b")


@pytest.mark.cuda
class TestZooOnCard:
    """Every family of the model zoo on the card against the port on the
    CPU, on the same weights (the CPU init moved to the card), at the smoke
    sizes: prefill and decode logits, and the engine's float32 streams."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU")
        torch.backends.cuda.matmul.allow_tf32 = False

    @staticmethod
    def _models(arch):
        import dataclasses
        from repro_torch.configs import get_smoke_config
        from repro_torch.models import build
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  compute_dtype="float32")
        cpu = build(cfg, device="cpu")
        params = cpu.init(torch.Generator().manual_seed(0))
        return cfg, cpu, params, build(cfg, device="cuda"), \
            _to(params, torch.device("cuda"))

    @pytest.mark.parametrize("arch", ZOO)
    def test_prefill_and_decode_match_the_cpu(self, arch):
        from repro_torch.launch import serve
        cfg, cpu, p, card, pc = self._models(arch)
        inputs, off = serve.frontend_batch(cfg, 2, 19, 2)
        toks = inputs["tokens"]
        batch = dict(inputs, tokens=toks[:, :16], max_len=off + 20)
        la, ca = cpu.prefill(p, batch)
        lb, cb = card.prefill(pc, batch)
        scale = float(la.abs().max())
        assert float((la - lb.cpu()).abs().max()) / scale < 1e-4
        for t in range(3):
            tok = torch.as_tensor(toks[:, 16 + t])
            la, ca = cpu.decode_step(p, ca, tok, off + 16 + t)
            lb, cb = card.decode_step(pc, cb, tok.cuda(), off + 16 + t)
            assert float((la - lb.cpu()).abs().max()) / scale < 1e-4, t

    @pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-7b",
                                      "rwkv6-1.6b"])
    def test_engine_streams_match_the_cpu(self, arch):
        from repro_torch.serving import Request, ServingEngine
        cfg, cpu, p, card, pc = self._models(arch)
        outs = []
        for model, params in ((cpu, p), (card, pc)):
            eng = ServingEngine(model, params, slots=3, max_len=48,
                                prompt_len=8)
            rng = np.random.RandomState(0)
            reqs = [Request(uid=i, prompt=rng.randint(0, cfg.vocab_size, 8)
                            .astype(np.int32), max_new_tokens=5 + i)
                    for i in range(7)]
            for r in reqs:
                eng.submit(r)
            s = eng.run_until_drained()
            outs.append(([r.output for r in reqs], (s.ticks, s.tokens_out)))
        assert outs[0] == outs[1]

    def test_serve_profile_profiles_a_zoo_step(self):
        """`serve_profile` on an MoE model (no decode TAF there) profiles
        the plain step alone, at a depth cut."""
        from repro_torch.benchmarks import serve_profile
        res = serve_profile.profile("olmoe-1b-7b", batch=2, prompt_len=16,
                                    layers=2)
        assert not res["decode_taf"] and res["n_layers"] == 2
        assert res["plain"]["kernels"] > 0 and "precise" not in res


@pytest.mark.cuda
class TestTrainOnCard:
    """The training half on the card against the port on the CPU, on the
    same float32 masters (the CPU draw moved to the card), TF32 off: every
    family's loss and gradients at the smoke sizes, a train step, the
    driver with resume, and the profiler module."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    @staticmethod
    def _setup(arch):
        import dataclasses
        from repro_torch.configs import get_smoke_config
        from repro_torch.data import DataConfig, SyntheticLM
        from repro_torch.launch import train
        from repro_torch.models import build
        cfg = dataclasses.replace(get_smoke_config(arch),
                                  compute_dtype="float32", remat=True)
        cpu = build(cfg, device="cpu")
        masters = cpu.masters(torch.Generator().manual_seed(0))
        seq = 32 if cfg.moe is not None else 16
        batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=seq, global_batch=2)).batch(0)
        batch = train.add_frontend_stub(batch, cfg,
                                        np.random.RandomState(0))
        return cfg, cpu, masters, build(cfg, device="cuda"), \
            _to(masters, torch.device("cuda")), batch

    @pytest.mark.parametrize("arch", ZOO + ("qwen3-1.7b", "deepseek-7b"))
    def test_loss_and_grads_match_the_cpu(self, arch):
        from repro_torch.launch import steps
        _, cpu, p, card, pc, batch = self._setup(arch)
        la, _, ga = steps.loss_and_grads(cpu, p, batch)
        lb, _, gb = steps.loss_and_grads(card, pc, batch)
        assert abs(float(la) - float(lb)) <= 1e-5 * abs(float(la))
        for a, b in zip(ga, gb):
            n = float(a.double().norm())
            d = float((a.double() - b.cpu().double()).norm())
            assert d <= 1e-4 * n if n > 0 else d == 0

    def test_train_step_matches_the_cpu(self):
        from repro_torch.launch import steps
        from repro_torch.optim import adamw
        _, cpu, p, card, pc, batch = self._setup("qwen3-1.7b")
        ocfg = adamw.AdamWConfig(lr=1e-3)
        pa, _, ma = steps.make_train_step(cpu, ocfg)(p, adamw.init(p), batch)
        pb, _, mb = steps.make_train_step(card, ocfg)(pc, adamw.init(pc),
                                                      batch)
        assert abs(float(ma["loss"]) - float(mb["loss"])) <= \
            1e-5 * abs(float(ma["loss"]))
        assert abs(float(ma["grad_norm"]) - float(mb["grad_norm"])) <= \
            1e-4 * float(ma["grad_norm"])
        for a, b in zip(adamw.leaves(pa), adamw.leaves(pb)):
            assert float((a - b.cpu()).abs().max()) <= 2 * ocfg.lr + 1e-6

    def test_driver_trains_and_resumes_on_the_card(self, tmp_path):
        from repro_torch.launch import train
        common = ["--arch", "deepseek-7b", "--smoke", "--batch", "4",
                  "--seq-len", "32", "--log-every", "100"]
        full = train.main(common + ["--steps", "20"])
        train.main(common + ["--steps", "10", "--ckpt-dir", str(tmp_path),
                             "--ckpt-every", "10"])
        resumed = train.main(common + ["--steps", "20", "--ckpt-dir",
                                       str(tmp_path), "--resume"])
        assert np.mean(full[-5:]) < np.mean(full[:5])
        np.testing.assert_allclose(resumed[-1], full[-1], rtol=1e-4)

    def test_train_profile_profiles_a_step(self):
        from repro_torch.benchmarks import train_profile
        res = train_profile.profile("qwen3-1.7b", batch=2, seq_len=64,
                                    layers=2)
        assert res["kernels"] > 0 and res["wall_ms"] > 0
        assert 0 < res["peak_gb"] < 80


def _dryrun_cells():
    """Every applicable (arch, shape, mesh) cell of the dry run."""
    from repro_torch.configs import SHAPES, get_config, list_archs
    from repro_torch.configs import shape_applicable
    return [(a, s, m) for a in list_archs() for s in SHAPES
            for m in ("16x16", "2x16x16")
            if shape_applicable(get_config(a), SHAPES[s])[0]]


# a DTensor's split moved from dim 0 to dim 1 over `model` on a mesh of 2 x 4
# fake ranks (argv[1]: the mesh's device type), counted by the dry run
_MOVE = r"""
import json, sys
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import dryrun
with dryrun.fake_world(8):
    mesh = init_device_mesh(sys.argv[1], (2, 4),
                            mesh_dim_names=("data", "model"))
    axes = {i["group"]: n for n, i in dryrun.mesh_axes(mesh).items()}
    count = dryrun.DeviceCount(axes)
    t = DTensor.from_local(torch.empty(4, 16, device="meta"), mesh,
                           [Replicate(), Shard(0)], run_check=False,
                           shape=(16, 16), stride=(16, 1))
    with count:
        t.redistribute(mesh, [Replicate(), Shard(1)])
print("RESULT " + json.dumps({"counts": count.counts,
                              "bytes": count.coll_bytes,
                              "axes": count.axis_bytes,
                              "moves": count.moves}))
"""


@pytest.mark.cuda
class TestDryRunOnCard:
    """Every applicable dry-run cell traces with the card's torch: each cut
    for a quick check (`launch.dryrun.short_cell`: full width, the
    roofline's smallest depth variant, short shapes) on a "cuda" mesh, an
    arch's cells in a process of their own, 8 at a time
    (`tests/_dryrun_cells.py`, the CPU tests'
    `test_torch_dryrun_cells_*.py` matrix), each laid out as the sharding
    rules say, and each, with the two-layer `VARIANTS`, counting the
    collectives committed in `tests/_dryrun_card_collectives.json`."""

    @pytest.fixture(scope="class")
    def records(self):
        import os
        import sys
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (the dry run's mesh device is "
                        "cuda)")
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import _dryrun_cells as dc
        from repro_torch.configs import list_archs
        return dc.trace_by_arch(list_archs(), ("cuda",))["cuda"]

    @pytest.fixture(scope="class")
    def rows(self, records):
        return {(a, s, "2x16x16" if m else "16x16"): r
                for (a, s, m, *layers), r in records.items() if not layers}

    @pytest.mark.parametrize("cell", _dryrun_cells(),
                             ids=lambda c: "-".join(c))
    def test_cell_traces(self, rows, cell):
        import os
        import sys
        row = rows[cell]
        assert row["status"] == "ok", row["error"]
        assert row["per_device_bytes"] > 0
        # laid out as the rules say: the arguments' local shards, and a
        # prefill's cache made on the mesh by `cache_specs`
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import _dryrun_cells as dc
        arch, shape, mesh = cell
        multi = mesh == "2x16x16"
        assert row["memory"]["argument_bytes"] == dc.argument_bytes(
            arch, shape, multi)
        if row["kind"] == "prefill":
            assert row["memory"]["output_bytes"] == dc.output_bytes(
                arch, shape, multi)

    def test_cells_count_the_committed_card_collectives(self, records):
        """Every cell and two-layer variant counts, on the card's torch and
        a cuda mesh, the `counts`, `bytes_by_kind` and `bytes_by_axis`
        committed in `tests/_dryrun_card_collectives.json`, which the CPU
        matrix is held to on its own torch (`_dryrun_cells.check`): a
        change to a collective regenerates that file on the card
        (`python tests/_dryrun_moves.py record --device cuda --out
        tests/_dryrun_card_collectives.json`)."""
        import os
        import sys
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        import _dryrun_cells as dc
        card = dc.card_records()
        assert sorted(dc.cell_id(c) for c in records) == sorted(card)
        differ = {dc.cell_id(c): r.get("error") or dc.card_differences(
            r, c, card) for c, r in records.items()
            if r["status"] != "ok" or dc.card_differences(r, c, card)}
        assert not differ, differ

    def test_meshes_count_the_same_moves(self):
        """A cuda mesh (DTensor's `_dtensor.shard_dim_alltoall`) and a cpu
        mesh (its all-gather and chunk) count a Shard-to-Shard move alike,
        as one all-to-all over its axis; and deepseek-v3-671b train_4k on
        16x16, whose MTP block moved splits before its sublayers got their
        input whole (`models.common.whole_along`), counts the same
        collectives on both meshes."""
        import json
        import os
        import subprocess
        import sys
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (the dry run's mesh device is "
                        "cuda)")
        here = os.path.dirname(os.path.abspath(__file__))
        sys.path.insert(0, here)
        import _dryrun_cells as dc
        moved = {}
        for device in ("cuda", "cpu"):
            r = subprocess.run(
                [sys.executable, "-c", _MOVE, device], capture_output=True,
                text=True, timeout=300, cwd=os.path.dirname(here),
                env=dict(os.environ, PYTHONPATH=os.path.join(
                    os.path.dirname(here), "src")))
            assert r.returncode == 0, r.stderr[-3000:]
            moved[device] = json.loads([
                l for l in r.stdout.splitlines()
                if l.startswith("RESULT ")][-1][len("RESULT "):])
        assert moved["cuda"] == moved["cpu"]
        assert moved["cuda"]["counts"] == {"all-to-all": 1}
        assert moved["cuda"]["moves"] == 1
        cell = ("deepseek-v3-671b", "train_4k", False)
        cuda = dc.trace([cell], device="cuda")[cell]
        cpu = dc.trace([cell], device="cpu")[cell]
        assert cuda["status"] == cpu["status"] == "ok"
        assert dc.mesh_differences(cuda, cpu) == {}
        assert cuda["collectives"]["shard_moves"] == \
            cpu["collectives"]["shard_moves"]


@pytest.mark.cuda
class TestSanitizeOnCard:
    """The nine CUDA kernels under `repro_torch.kernels.sanitize`, each tool
    in a process of its own (the checked build and the release one cannot
    share a process), as `chip_smoke.py` phase 3b runs them: no finding,
    every case equal to its plain version, every kernel launched."""

    @pytest.mark.parametrize("tool", ("memcheck", "racecheck", "synccheck",
                                      "initcheck"))
    def test_tool_finds_nothing(self, tool):
        import json
        import os
        import subprocess
        import sys
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no "
                        "interpret mode)")
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.kernels.sanitize", "--tool",
             tool], capture_output=True, text=True, timeout=600, cwd=root,
            env=dict(os.environ, PYTHONPATH=os.path.join(root, "src"),
                     PYTORCH_NO_CUDA_MEMORY_CACHING="1"))
        assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
        summary = json.loads(r.stdout.strip().splitlines()[-1])
        assert summary["errors"] == 0 and not summary["not_launched"]
        assert all(n > 0 for n in summary["launches"].values())
