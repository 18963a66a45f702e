"""The port's kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: they skip without a card. On the GPU, where JAX is not
installed, run them without the suite's JAX conftest::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the hotness-1 gather and the bottom-row copy of the
interaction are bit-exact; fp32-accumulated sums (hotness 3, weights,
the pair dot products) are within 1 bf16 ulp of the plain result (bf16)
or 1e-6 / 1e-5 relative (fp32), since the kernel sums in another order
(K2's tensor-core kernel sums a pair that nearly cancels again in fp32,
in order, to stay there). K2 and K4 on the features where the DLRM step
leaves them (the list form) give the stacked form's bits, and a K2 + K4
pair replays in a CUDA graph bit-exact to eager.
The interaction backward (K4) is within 1 bf16 ulp of the plain result
plus 2^-20 of the sum of |terms| (fp32 order; fp32: 1e-5 of that sum).
The SGD scatter (K3) is bit-exact on rows one id updates and on dyadic
float32 duplicates; against the card's ``index_add_`` a row that k ids
update with inexact sums is within k ulps of its dtype of ``|old| + sum
|update|`` (the plain version's atomics add in an order of the card's
choosing); against its plain version run on the CPU (stream order) K3
is bit-exact on every row hit at most L = 256 times, and the same bits
on every launch. A small DLRM trained 5
steps on the card (kernels) and on the CPU (plain versions), float32:
losses, tables and dense params within 1e-4 (cuBLAS and the CPU sum in
other orders). The dedup (K5), Adagrad row (K6) and dense (K7) kernels,
the Adam (K11) and momentum (K12) row kernels and the 3-step tiny-zoo
runs card-vs-CPU state their bounds where they are tested. The
streaming remap (K16) and commit (K17) are bit-exact (a NaN equals a
NaN); the streaming train run card-vs-CPU holds the streaming state
bitwise and the floats within 1e-4. The promoted scatter (K18) and K3's
dedup chain are bit-exact to their plain versions run on CPU copies (a
NaN equals a NaN), and the DLRM example resumed from a checkpoint on the
card equals its uninterrupted run bitwise. The gradient-health reduction
(K21) equals its plain version in max |g| and the non-finite counts and
within 1.2e-5 relative in the sums of squares (positive terms in another
order), and gives the same bits on two runs; the dense update (K22) is
bit-exact; K14's pool and K15's merge past their shared-memory tiles are
bit-exact; an instrumented DLRM run card-vs-CPU holds its metrics within
1e-4 (counts exact). K22 and K19/K20 through their launch records are
bit-exact to their plain versions on record hits and after a rebuild,
and replayed in a CUDA graph bit-exact to eager launches, as are K1 and
the three K10 wrappers. K10 is bit-exact over multi-tile scans, totals
past 2^31, 2.4M-entry COO rows and every capacity; on rows that do not
ascend every entry it writes lies in [0, nnz]. K1's bounds at hot 10 and
at its wide grid are stated in its test.
"""

import numpy as np
import pytest
import torch

from distributed_embeddings_torch.models import (
    DLRMConfig, DLRMDense, InputGenerator, bce_with_logits, build_synthetic,
    synthetic_models_v3)
from distributed_embeddings_torch.ops import (
    adagrad_dense, adagrad_dense_plain, adagrad_rows, adagrad_rows_plain,
    adam_rows, adam_rows_plain, momentum_rows, momentum_rows_plain,
    dedup_sparse_grad, dedup_sparse_grad_plain, dot_interact_bwd,
    dot_interact_bwd_plain, dot_interact_fwd, dot_interact_fwd_plain,
    embedding_lookup, gather_combine, gather_combine_plain, sgd_scatter,
    sgd_scatter_plain)
from distributed_embeddings_torch.parallel import (
    SGD, Adagrad, Adam, DistributedEmbedding, HybridTrainState, ServeConfig,
    Served, ServingRuntime, SparseAdagrad, SparseAdam, SparseMomentum,
    SparseSGD, make_hybrid_train_step, synthetic_request)

from torch_parity import (assert_within_ulps, bf16_ulp,  # noqa: F401
                          cuda_device, to_np)

torch.set_num_threads(1)


def _ids(rng, vocab, shape):
    """Ids mostly in range, with negatives and ids past the table."""
    return rng.integers(-3, vocab + 3, size=shape).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [3, 8, 16, 24, 128])
@pytest.mark.parametrize("b,aligned", [(70, True), (6001, True),
                                       (6001, False)])
def test_gather_combine_kernel_matches_plain(cuda_device, dtype, width, b,
                                             aligned):
    """K1 against its plain version at hot 1, 3 and 10, with and without
    weights and the mask, int32 and int64 ids. b=70 and b=6001 (3 x 6001
    rows) are not multiples of the rows a block takes (2 a lane group);
    an unaligned slab view (one element past an allocation) narrows the
    lane loads. Tolerances: hot 1 without
    weights bit-exact; fp32 sums at hot 3 1e-6; bf16 sums at b=70, hot 3,
    1 bf16 ulp of |want|. Hot 10, and bf16 at b=6001, where weighted sums
    that cancel to ~1e-6 occur among 18,003 rows: 16 fp32 ulps of
    sum |f x| / div (the kernel's fmaf chain against the plain version's
    rounded products) plus, in bf16, one ulp of the larger side."""
    from distributed_embeddings_torch.ops.embedding_lookup import (
        vector_bytes)

    rng = np.random.default_rng(width + b)
    n, rows = 3, 50
    host = torch.from_numpy(rng.normal(size=(n * rows, width))
                            .astype(np.float32)).to(dtype)
    if aligned:
        slab = host.to(cuda_device)
    else:
        buf = torch.empty(n * rows * width + 1, dtype=dtype,
                          device=cuda_device)
        slab = buf[1:].view(n * rows, width)
        slab.copy_(host)
        assert vector_bytes(slab) == slab.element_size()
    for ids_dtype in (torch.int32, torch.int64):
        for hot_ in (1, 3, 10):
            ids = torch.from_numpy(_ids(rng, rows, (n, b, hot_))).to(
                ids_dtype).to(cuda_device)
            meta = dict(
                rows=torch.full((n,), rows, dtype=torch.int64,
                                device=cuda_device),
                roff=torch.arange(n, dtype=torch.int64,
                                  device=cuda_device) * rows,
                div=torch.tensor([1.0, float(hot_), 1.0],
                                 device=cuda_device),
                mask=torch.tensor([0, 1, 0], dtype=torch.int32,
                                  device=cuda_device),
                weights=torch.from_numpy(rng.uniform(
                    0.5, 2, size=(n, b, hot_)).astype(np.float32)).to(
                    cuda_device))
            for drop in ((), ("mask",), ("weights",), ("mask", "weights")):
                kw = {k: v for k, v in meta.items() if k not in drop}
                got = to_np(gather_combine(slab, ids, **kw))
                want = to_np(gather_combine_plain(slab, ids, **kw))
                if hot_ == 1 and "weights" in drop:
                    np.testing.assert_array_equal(got, want)
                    continue
                if dtype == torch.float32 and hot_ < 10:
                    np.testing.assert_allclose(got, want, rtol=1e-6,
                                               atol=1e-6)
                    continue
                if dtype == torch.bfloat16 and hot_ < 10 and b == 70:
                    assert_within_ulps(got, want,
                                       np.maximum(np.abs(want), 1e-30), 1,
                                       f"w{width} hot{hot_} {drop}")
                    continue
                # two fp32 summation orders (fmaf chain, rounded
                # products summed): 16 fp32 ulps of sum |f x| / div, then
                # (bf16) one ulp of the larger side's rounding
                akw = dict(kw)
                if "weights" in akw:
                    akw["weights"] = akw["weights"].abs()
                scale = to_np(gather_combine_plain(
                    slab.float().abs(), ids, **akw)).astype(np.float64)
                tol = 16 * 2.0 ** -24 * scale
                if dtype == torch.bfloat16:
                    tol = tol + bf16_ulp(np.maximum(np.abs(got),
                                                    np.abs(want)))
                err = np.abs(got.astype(np.float64) - want)
                assert (err <= tol).all(), (
                    f"w{width} hot{hot_} {drop}: {int((err > tol).sum())} "
                    f"beyond; max err {err.max()}")


def _k2_close(got, want, dtype, what):
    """K2 against its plain version: fp32 within 1e-5; bf16 within 1
    bf16 ulp."""
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert_within_ulps(got, want, np.maximum(np.abs(want), 1e-30), 1,
                           what)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 27, 128), (257, 27, 128),
                                   (33, 27, 16), (9, 5, 13),
                                   (65536, 27, 128)])
def test_dot_interact_kernel_matches_plain(cuda_device, dtype, shape):
    feats = torch.randn(shape, generator=torch.Generator().manual_seed(3)
                        ).to(dtype).to(cuda_device)
    got = to_np(dot_interact_fwd(feats))
    want = to_np(dot_interact_fwd_plain(feats))
    d = shape[2]
    np.testing.assert_array_equal(got[:, -d:], want[:, -d:])
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert_within_ulps(got, want, np.maximum(np.abs(want), 1e-30), 1,
                           "dot_interact")


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_bad_inputs(cuda_device):
    slab = torch.zeros(4, 8, dtype=torch.float16, device=cuda_device)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        embedding_lookup(slab, torch.tensor([1], device=cuda_device))
    with pytest.raises(ValueError, match="ids"):
        gather_combine(slab.float(), torch.zeros(1, 2, 1, device=cuda_device),
                       torch.ones(1, dtype=torch.int64, device=cuda_device),
                       torch.zeros(1, dtype=torch.int64, device=cuda_device),
                       torch.ones(1, device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        dot_interact_fwd(torch.zeros(4, 8, 3, device=cuda_device
                                     ).transpose(1, 2))


@pytest.mark.cuda
def test_served_dlrm_on_the_card_matches_the_cpu(cuda_device):
    """A small bf16 DLRM served on the card (through both kernels)
    against the same model and requests on the CPU (plain versions):
    identical outcomes, predictions within 2e-2 (bf16 MLP products round
    at other places on the two devices)."""
    sizes = [500, 7, 33, 1200]
    cfg = DLRMConfig(table_sizes=sizes, embedding_dim=128,
                     num_numerical_features=13, bottom_mlp_dims=(64, 128),
                     top_mlp_dims=(64, 1), compute_dtype=torch.bfloat16)
    de = DistributedEmbedding(cfg.embedding_configs(), world_size=1,
                              compute_dtype=torch.bfloat16)
    params = de.init(torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                     device="cpu")
    dense = DLRMDense(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(1))
    results = {}
    before = (gather_combine.launches, dot_interact_fwd.launches)
    for dev in ("cpu", cuda_device):
        d = DLRMDense(cfg, device=dev)
        d.load_state_dict(dense.state_dict())
        state = HybridTrainState(
            emb_params={k: v.to(dev) for k, v in params.items()},
            dense_params=d)
        rt = ServingRuntime(
            de, lambda m, outs, n: torch.sigmoid(m(n, outs))[:, 0], state,
            config=ServeConfig(max_batch=32, max_wait_ms=0))
        rng = np.random.default_rng(5)
        tmpl = synthetic_request(rng, sizes, 2, numerical=13)
        rt.warmup((tmpl.cats, tmpl.batch))
        out = []
        for i in range(12):
            rt.submit(synthetic_request(rng, sizes, 1 + i % 8,
                                        numerical=13), now=0.0)
            out += rt.poll(now=0.0)
        out += rt.flush()
        results[str(dev)] = out
    assert (gather_combine.launches, dot_interact_fwd.launches) > before
    cpu, gpu = results["cpu"], results[str(cuda_device)]
    assert [(type(r), r.rid, r.rung) for r in gpu] == [
        (type(r), r.rid, r.rung) for r in cpu]
    assert all(isinstance(r, Served) for r in gpu)
    for a, b in zip(gpu, cpu):
        np.testing.assert_allclose(a.predictions, b.predictions, atol=2e-2,
                                   rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("slab_dtype,vals_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("width", [3, 8, 16, 24, 128])
def test_sgd_scatter_kernel_matches_plain(cuda_device, slab_dtype,
                                          vals_dtype, width):
    rng = np.random.default_rng(width)
    R = 300
    for ids_dtype in (torch.int32, torch.int64):
        # unique rows (some from the end), the sentinel, ids past the slab
        # and below -R: bit-exact
        rows = rng.permutation(R)[:200]
        ids = np.where(rng.random(200) < 0.3, rows - R, rows)
        ids = np.concatenate([ids, [R, R + 1, 10 ** 6, -R - 1]])
        slab = torch.from_numpy(rng.normal(size=(R, width)).astype(
            np.float32)).to(slab_dtype).to(cuda_device)
        vals = torch.from_numpy(rng.normal(size=(len(ids), width)).astype(
            np.float32)).to(vals_dtype).to(cuda_device)
        tid = torch.from_numpy(ids).to(ids_dtype).to(cuda_device)
        for lr in (0.005, 0.37):
            got, want = slab.clone(), slab.clone()
            sgd_scatter(got, tid, vals, lr)
            sgd_scatter_plain(want, tid, vals, lr)
            np.testing.assert_array_equal(to_np(got), to_np(want))
        # duplicates: Zipfian ids into a few hot rows
        ids = (rng.zipf(1.2, size=2000) - 1) % (R + 5)
        tid = torch.from_numpy(ids).to(ids_dtype).to(cuda_device)
        if slab_dtype == torch.float32:  # dyadic: every sum exact
            slab = torch.from_numpy(rng.integers(-64, 64, size=(R, width))
                                    .astype(np.float32) / 16).to(cuda_device)
            vals = torch.from_numpy(rng.integers(-32, 32, size=(
                len(ids), width)).astype(np.float32) / 8).to(
                vals_dtype).to(cuda_device)
            got, want = slab.clone(), slab.clone()
            sgd_scatter(got, tid, vals, 0.25)
            sgd_scatter_plain(want, tid, vals, 0.25)
            np.testing.assert_array_equal(to_np(got), to_np(want))
            # a float32 device lr (a callable schedule's): the products
            # are inexact, so a row k ids update is within k float32 ulps
            # (2^-16 bf16 ulps) of |old| + sum |update|
            lr = torch.tensor(0.013, device=cuda_device)
            got, want = slab.clone(), slab.clone()
            sgd_scatter(got, tid, vals, lr)
            sgd_scatter_plain(want, tid, vals, lr)
            keep = ids < R
            k = np.bincount(ids[keep], minlength=R)[:, None]
            mag = np.zeros((R, width))
            np.add.at(mag, ids[keep], np.abs(0.013 * to_np(vals)[keep]))
            assert_within_ulps(to_np(got), to_np(want),
                               np.abs(to_np(slab)) + mag, k * 2.0 ** -16,
                               f"w{width} duplicates, tensor lr")
        else:
            vals = torch.from_numpy(rng.normal(size=(len(ids), width))
                                    .astype(np.float32)).to(vals_dtype).to(
                cuda_device)
            got, want = slab.clone(), slab.clone()
            sgd_scatter(got, tid, vals, 0.05)
            sgd_scatter_plain(want, tid, vals, 0.05)
            keep = ids < R
            k = np.bincount(ids[keep], minlength=R)[:, None]
            mag = np.zeros((R, width))
            np.add.at(mag, ids[keep], np.abs(0.05 * to_np(vals)[keep]))
            assert_within_ulps(to_np(got), to_np(want),
                               np.abs(to_np(slab)) + mag, k + 0.0,
                               f"w{width} duplicates")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 27, 128), (257, 27, 128),
                                   (33, 27, 16), (9, 5, 13),
                                   (65536, 27, 128)])
def test_dot_interact_bwd_kernel_matches_plain(cuda_device, dtype, shape):
    g = torch.Generator().manual_seed(4)
    b, f, d = shape
    feats = torch.randn(shape, generator=g).to(dtype).to(cuda_device)
    dy = torch.randn((b, f * (f - 1) // 2 + d), generator=g).to(dtype).to(
        cuda_device)
    got = to_np(dot_interact_bwd(feats, dy))
    want = to_np(dot_interact_bwd_plain(feats, dy))
    scale = to_np(dot_interact_bwd_plain(feats.float().abs(),
                                         dy.float().abs()))
    if dtype == torch.float32:
        np.testing.assert_array_less(np.abs(got - want), 1e-5 * scale + 1e-30)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                  2.0 ** -126))) - 7)
        np.testing.assert_array_less(np.abs(got - want),
                                     ulp + 2.0 ** -20 * scale + 1e-30)


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu(cuda_device):
    """A small float32 DLRM trained 5 steps on the card (all four
    kernels) and on the CPU (their plain versions) from one state."""
    sizes = [500, 7, 33, 1200]
    cfg = DLRMConfig(table_sizes=sizes, embedding_dim=16,
                     num_numerical_features=13, bottom_mlp_dims=(32, 16),
                     top_mlp_dims=(64, 1))
    de = DistributedEmbedding(cfg.embedding_configs(), world_size=1)
    params = de.init(torch.Generator().manual_seed(0), device="cpu")
    dense = DLRMDense(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(1))

    def loss_fn(m, outs, batch):
        return bce_with_logits(m(batch[0], outs), batch[1])

    rng = np.random.default_rng(2)
    batches = [([_ids(rng, s, (256,)) for s in sizes],
                rng.normal(size=(256, 13)).astype(np.float32),
                (rng.random(256) < 0.3).astype(np.float32))
               for _ in range(5)]
    out = {}
    kernels = (gather_combine, dot_interact_fwd, dot_interact_bwd,
               sgd_scatter)
    for dev in ("cpu", cuda_device):
        d = DLRMDense(cfg, device=dev)
        d.load_state_dict(dense.state_dict())
        state = HybridTrainState(
            emb_params={k: v.clone().to(dev) for k, v in params.items()},
            emb_opt_state=SparseSGD().init(params), dense_params=d,
            dense_opt_state=(),
            step=torch.zeros((), dtype=torch.int32, device=dev))
        step = make_hybrid_train_step(de, loss_fn, SGD(0.1), SparseSGD(),
                                      lr_schedule=0.1)
        before = [k.launches for k in kernels]
        losses = []
        for cats, num, lab in batches:
            loss, state = step(state, [torch.from_numpy(c).to(dev)
                                       for c in cats],
                               (torch.from_numpy(num).to(dev),
                                torch.from_numpy(lab).to(dev)))
            losses.append(float(loss))
        launched = [k.launches - b for k, b in zip(kernels, before)]
        assert launched == ([0, 0, 0, 0] if dev == "cpu" else [5] * 4)
        out[str(dev)] = (losses, de.get_weights(state.emb_params),
                         [p.detach().cpu() for p in d.parameters()])
    (lc, tc, dc), (lg, tg, dg) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_allclose(lg, lc, atol=1e-4, rtol=0)
    for a, b in zip(tg, tc):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    for a, b in zip(dg, dc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=0)


def _dedup_case(rng, n, rows, hot_run=0):
    """Zipfian ids into ``rows`` (the sentinel, ids past it and negative
    ids mixed in), plus ``hot_run`` copies of one id, shuffled: a segment
    that spans many 256-row chunks of the kernel's segment-sum."""
    ids = (rng.zipf(1.1, size=n) - 1) % rows
    flip = rng.random(n) < 0.03
    ids = np.where(flip, rng.choice([rows, rows + 5, -2, -rows - 9], size=n),
                   ids)
    ids = rng.permutation(np.concatenate([ids, np.full(hot_run, 7)]))
    return ids


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [1, 8, 16, 40, 128])
def test_dedup_kernel_matches_plain(cuda_device, dtype, width):
    """K5 against its plain version: unique ids bit-exact (tail
    included); a row that k ids sum is a fp32 sum taken in stable order
    in 256-row pieces by the kernel and with atomics by the plain
    version, each within (k - 1) 2^-24 of the sum of |rows|: float32
    sums within 2 k 2^-24 of it, bf16 sums within 1 bf16 ulp of the
    plain result more (both round one fp32 sum once). Two runs of the
    kernel agree bitwise. The streams mix negative ids, the sentinel and
    ids past it; one repeats an id 50,000 times, two bound the distinct
    ids below their count (``max_unique``), one clears entries with a
    ``valid`` mask, one has int64 ids past 2^32."""
    rng = np.random.default_rng(width)
    for n, rows, hot_run, ids_dtype, kw in (
            (1, 10, 0, torch.int32, {}),
            (700, 50, 0, torch.int64, {}),
            (20000, 3000, 9000, torch.int32, {}),
            (5000, 10 ** 6, 2000, torch.int32, {}),
            (3000, 100, 0, torch.int32, {"max_unique": 40}),
            (3000, 100, 600, torch.int64, {"valid": True}),
            (30000, 70000, 50000, torch.int32, {}),
            (4000, 3 * 2 ** 32, 500, torch.int64, {"max_unique": 900})):
        ids = _dedup_case(rng, n, rows, hot_run)
        tid = torch.from_numpy(ids).to(ids_dtype).to(cuda_device)
        vals = torch.from_numpy(rng.normal(size=(len(ids), width)).astype(
            np.float32)).to(dtype).to(cuda_device)
        if kw.get("valid"):
            kw = {"valid": torch.from_numpy(rng.random(len(ids)) < 0.7).to(
                cuda_device)}
        before = dedup_sparse_grad.launches
        gu, gg = dedup_sparse_grad(tid, vals, pad_id=rows, **kw)
        gu2, gg2 = dedup_sparse_grad(tid, vals, pad_id=rows, **kw)
        assert dedup_sparse_grad.launches == before + 2
        pu, pg = dedup_sparse_grad_plain(tid, vals, pad_id=rows, **kw)
        assert gu.dtype == ids_dtype and gg.dtype == dtype
        assert torch.equal(gu, gu2) and torch.equal(gg, gg2)
        np.testing.assert_array_equal(to_np(gu), to_np(pu))
        _, mag = dedup_sparse_grad_plain(tid, vals.float().abs(),
                                         pad_id=rows, **kw)
        _, cnt = dedup_sparse_grad_plain(
            tid, torch.ones((len(ids), 1), device=cuda_device), pad_id=rows,
            **kw)
        got, want, mag = to_np(gg), to_np(pg), to_np(mag)
        tol = 2 * to_np(cnt) * 2.0 ** -24 * mag + 1e-30
        if dtype == torch.bfloat16:
            tol = tol + 2.0 ** (np.floor(np.log2(np.maximum(
                np.abs(want), 2.0 ** -126))) - 7)
        np.testing.assert_array_less(np.abs(got - want), tol)


ADAGRAD_PAIRS = [(torch.float32, torch.float32),
                 (torch.bfloat16, torch.bfloat16),
                 (torch.bfloat16, torch.float32),
                 (torch.float32, torch.bfloat16)]


def _adagrad_tol(got, want, old, lr, slab_dtype):
    """The kernel's correctly rounded rsqrt against PyTorch's CUDA
    ``rsqrtf`` (within 2 ulps): the update, below lr, may differ by 2
    ulps and its rounding by one more, so the slab is held within 3 ulps
    of ``|old| + lr`` (a bound on |old| and |update|) of its dtype."""
    mant = 7 if slab_dtype == torch.bfloat16 else 23
    scale = np.abs(old) + lr
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(scale, 2.0 ** -126))) - mant)
    bad = np.abs(got - want) > 3 * ulp
    assert not bad.any(), (f"{int(bad.sum())} values beyond 3 ulps; max "
                           f"err {np.abs(got - want).max()}")


@pytest.mark.cuda
@pytest.mark.parametrize("slab_dtype,acc_dtype", ADAGRAD_PAIRS)
@pytest.mark.parametrize("width", [8, 16, 40])
def test_adagrad_rows_kernel_matches_plain(cuda_device, slab_dtype,
                                           acc_dtype, width):
    """K6 against its plain version on unique rows, negative ids, the
    sentinel and ids past the slab, for a constant and a device lr:
    accumulators bit-exact (the same per-op rounding), slab rows within
    3 ulps (``rsqrt``, see ``_adagrad_tol``), untouched rows bitwise
    unchanged."""
    rng = np.random.default_rng(width)
    R = 400
    rows = rng.permutation(R - 20)[:150]  # rows R-20.. stay for negatives
    uids = np.concatenate([np.sort(rows), [-1, -7, R, R, 10 ** 6, -R - 3]])
    for ids_dtype in (torch.int32, torch.int64):
        for lr in (0.05, torch.tensor(0.013)):
            slab = torch.from_numpy(rng.normal(size=(R, width)).astype(
                np.float32)).to(slab_dtype).to(cuda_device)
            acc = torch.from_numpy((0.1 + rng.random((R, width))).astype(
                np.float32)).to(acc_dtype).to(cuda_device)
            g = torch.from_numpy(rng.normal(size=(len(uids), width)).astype(
                np.float32)).to(acc_dtype).to(cuda_device)
            tid = torch.from_numpy(uids).to(ids_dtype).to(cuda_device)
            lr_d = lr.to(cuda_device) if isinstance(lr, torch.Tensor) else lr
            gs, ga, ps, pa = slab.clone(), acc.clone(), slab.clone(), \
                acc.clone()
            before = adagrad_rows.launches
            adagrad_rows(gs, ga, tid, g, lr_d, 1e-7)
            assert adagrad_rows.launches == before + 1
            adagrad_rows_plain(ps, pa, tid, g, lr_d, 1e-7)
            np.testing.assert_array_equal(to_np(ga), to_np(pa))
            _adagrad_tol(to_np(gs), to_np(ps), to_np(slab), float(lr),
                         slab_dtype)
            hit = np.union1d(rows, [R - 1, R - 7])
            untouched = np.setdiff1d(np.arange(R), hit)
            assert torch.equal(gs[untouched], slab[untouched])
            assert torch.equal(ga[untouched], acc[untouched])


@pytest.mark.cuda
@pytest.mark.parametrize("slab_dtype,acc_dtype", ADAGRAD_PAIRS)
def test_adagrad_dense_kernel_matches_plain(cuda_device, slab_dtype,
                                            acc_dtype):
    """K7 against its plain version over a slab whose gradient is zero
    on most rows: accumulators bit-exact, slab within 3 ulps (as K6), and
    every element with g = 0 keeps its bits."""
    rng = np.random.default_rng(3)
    R, w = 5000, 16
    for lr in (0.05, torch.tensor(0.013)):
        slab = torch.from_numpy(rng.normal(size=(R, w)).astype(
            np.float32)).to(slab_dtype).to(cuda_device)
        acc = torch.from_numpy((0.1 + rng.random((R, w))).astype(
            np.float32)).to(acc_dtype).to(cuda_device)
        g = torch.from_numpy(rng.normal(size=(R, w)).astype(np.float32)
                             * (rng.random((R, 1)) < 0.1)).to(acc_dtype).to(
            cuda_device)
        lr_d = lr.to(cuda_device) if isinstance(lr, torch.Tensor) else lr
        gs, ga, ps, pa = slab.clone(), acc.clone(), slab.clone(), acc.clone()
        before = adagrad_dense.launches
        adagrad_dense(gs, ga, g, lr_d, 1e-7)
        assert adagrad_dense.launches == before + 1
        adagrad_dense_plain(ps, pa, g, lr_d, 1e-7)
        np.testing.assert_array_equal(to_np(ga), to_np(pa))
        _adagrad_tol(to_np(gs), to_np(ps), to_np(slab), float(lr),
                     slab_dtype)
        zero = (g == 0).cpu()
        assert torch.equal(gs.cpu()[zero], slab.cpu()[zero])
        assert torch.equal(ga.cpu()[zero], acc.cpu()[zero])


@pytest.mark.cuda
@pytest.mark.parametrize("ratio", [6.0, None], ids=["dense", "sparse"])
def test_zoo_train_on_the_card_matches_the_cpu(cuda_device, ratio):
    """The capped tiny zoo trained 3 steps with ``SparseAdagrad`` +
    ``Adagrad`` on the card (K1, then K3 + K7 or K5 + K6 per slab) and on
    the CPU (the plain versions) from one state, float32: losses within
    1e-5 relative, tables within 1e-5, accumulators and dense params
    within 1e-4 relative / absolute (cuBLAS and the CPU sum in other
    orders; K5 sums in pieces)."""
    cfg = synthetic_models_v3["tiny"]
    gen = InputGenerator(cfg, 128, alpha=1.05, num_batches=3, seed=4,
                         row_cap=500, device="cpu")
    out = {}
    for dev in ("cpu", cuda_device):
        de, dense, _ = build_synthetic(
            cfg, 1, row_cap=500, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))
        if dev == "cpu":
            init = de.init(torch.Generator().manual_seed(1), device="cpu")
            dense_init = {k: v.clone() for k, v in dense.state_dict().items()}
        dense.load_state_dict(dense_init)
        state = HybridTrainState(
            emb_params={k: v.clone().to(dev) for k, v in init.items()},
            emb_opt_state=SparseAdagrad().init(
                {k: v.to(dev) for k, v in init.items()}),
            dense_params=dense,
            dense_opt_state=Adagrad(0.01).init(list(dense.parameters())),
            step=torch.zeros((), dtype=torch.int32, device=dev))
        opt = SparseAdagrad(dense_apply_ratio=ratio)
        step = make_hybrid_train_step(de, _mse, Adagrad(0.01), opt,
                                      lr_schedule=0.01)
        kernels = (sgd_scatter, adagrad_dense, dedup_sparse_grad,
                   adagrad_rows)
        before = [k.launches for k in kernels]
        losses = []
        for k in range(3):
            n, c, y = gen[k]
            loss, state = step(state, [t.to(dev) for t in c],
                               (n.to(dev), y.to(dev)))
            losses.append(float(loss))
        launched = [k.launches - b for k, b in zip(kernels, before)]
        slabs = 2 * 3  # two width slabs, three steps
        if dev == "cpu":
            assert launched == [0, 0, 0, 0]
        elif ratio is None:
            assert launched == [0, 0, slabs, slabs]
        else:
            assert launched == [slabs, slabs, 0, 0]
        out[str(dev)] = (np.array(losses), de.get_weights(state.emb_params),
                         {k: to_np(v) for k, v in
                          state.emb_opt_state.items()},
                         [p.detach().cpu() for p in dense.parameters()])
    (lc, tc, ac, dc), (lg, tg, ag, dg) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    for a, b in zip(tg, tc):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    for k in ac:
        np.testing.assert_allclose(ag[k], ac[k], rtol=1e-4, atol=0)
    for a, b in zip(dg, dc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=0)


# ------------------------------------------------- K11 / K12: Adam, momentum


def _row_case(rng, R, width, dtype, device, n_rows=150, unaligned=False):
    """Unique sorted ids (no 0: a negative id reads row 0, and K6/K11/K12
    read it in no set order against row 0's own update), negative ids,
    the sentinel, ids past the slab and a pad tail; gradient rows in
    ``dtype`` (``unaligned``: a contiguous view 4 bytes off its buffer,
    so the kernel takes its one-element path)."""
    rows = 1 + rng.permutation(R - 21)[:n_rows]  # rows R-20.. for negatives
    uids = np.concatenate([np.sort(rows), [-1, -7, R, R, 10 ** 6, -R - 3]])
    g = rng.normal(size=(len(uids), width)).astype(np.float32)
    gt = torch.from_numpy(g).to(dtype).to(device)
    if unaligned:
        buf = torch.empty(g.size + 1, dtype=dtype, device=device)
        buf[1:] = gt.reshape(-1)
        gt = buf[1:].view(len(uids), width)
        assert gt.data_ptr() % 16 != 0
    return uids, gt, np.union1d(rows, [R - 1, R - 7])


ROW_CASES = [(8, False), (16, False), (40, False), (3, False), (16, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("slab_dtype,mom_dtype", ADAGRAD_PAIRS)
@pytest.mark.parametrize("width,unaligned", ROW_CASES)
def test_adam_rows_kernel_matches_plain(cuda_device, slab_dtype, mom_dtype,
                                        width, unaligned):
    """K11 against its plain version (on the card) on unique rows,
    negative ids, the sentinel, ids past the slab and the pad tail, for
    a constant and a device lr and counts 1 and 1000, int32 and int64
    ids, 4-element and one-element loads: slab, mu and nu bit-exact
    (the same correctly rounded ops in the same order; the bias
    corrections come from one computation), untouched rows bitwise
    unchanged."""
    rng = np.random.default_rng(width + 100 * unaligned)
    R = 400
    uids, g, hit = _row_case(rng, R, width, mom_dtype, cuda_device,
                             unaligned=unaligned)
    untouched = np.setdiff1d(np.arange(R), hit)
    for ids_dtype, lr, count in ((torch.int32, 0.01, 1.0),
                                 (torch.int64, torch.tensor(0.013), 1000.0),
                                 (torch.int32, torch.tensor(0.013), 1.0),
                                 (torch.int64, 0.01, 1000.0)):
        slab = torch.from_numpy(rng.normal(size=(R, width)).astype(
            np.float32)).to(slab_dtype).to(cuda_device)
        mu = torch.from_numpy(rng.normal(size=(R, width)).astype(
            np.float32) * 0.1).to(mom_dtype).to(cuda_device)
        nu = torch.from_numpy(rng.random((R, width)).astype(
            np.float32) * 0.1).to(mom_dtype).to(cuda_device)
        cnt = torch.full((1, 1), count, device=cuda_device)
        tid = torch.from_numpy(uids).to(ids_dtype).to(cuda_device)
        lr_d = lr.to(cuda_device) if isinstance(lr, torch.Tensor) else lr
        got = [slab.clone(), mu.clone(), nu.clone()]
        want = [slab.clone(), mu.clone(), nu.clone()]
        before = adam_rows.launches
        adam_rows(*got, cnt, tid, g, lr_d, 0.9, 0.999, 1e-8, 0.0)
        assert adam_rows.launches == before + 1
        adam_rows_plain(*want, cnt, tid, g, lr_d, 0.9, 0.999, 1e-8, 0.0)
        for a, b, old in zip(got, want, (slab, mu, nu)):
            np.testing.assert_array_equal(to_np(a), to_np(b))
            assert torch.equal(a[untouched], old[untouched])
        assert not torch.equal(got[0], slab)


@pytest.mark.cuda
@pytest.mark.parametrize("slab_dtype,tr_dtype", ADAGRAD_PAIRS)
@pytest.mark.parametrize("width,unaligned", ROW_CASES)
def test_momentum_rows_kernel_matches_plain(cuda_device, slab_dtype,
                                            tr_dtype, width, unaligned):
    """K12 against its plain version as K11 above, with and without
    Nesterov: slab and trace bit-exact, untouched rows unchanged."""
    rng = np.random.default_rng(width + 100 * unaligned + 7)
    R = 400
    uids, g, hit = _row_case(rng, R, width, tr_dtype, cuda_device,
                             unaligned=unaligned)
    untouched = np.setdiff1d(np.arange(R), hit)
    for ids_dtype, lr, nest in ((torch.int32, 0.01, False),
                                (torch.int64, torch.tensor(0.013), True),
                                (torch.int32, torch.tensor(0.013), False),
                                (torch.int64, 0.01, True)):
        slab = torch.from_numpy(rng.normal(size=(R, width)).astype(
            np.float32)).to(slab_dtype).to(cuda_device)
        tr = torch.from_numpy(rng.normal(size=(R, width)).astype(
            np.float32) * 0.1).to(tr_dtype).to(cuda_device)
        tid = torch.from_numpy(uids).to(ids_dtype).to(cuda_device)
        lr_d = lr.to(cuda_device) if isinstance(lr, torch.Tensor) else lr
        got, want = [slab.clone(), tr.clone()], [slab.clone(), tr.clone()]
        before = momentum_rows.launches
        momentum_rows(*got, tid, g, lr_d, 0.9, nest)
        assert momentum_rows.launches == before + 1
        momentum_rows_plain(*want, tid, g, lr_d, 0.9, nest)
        for a, b, old in zip(got, want, (slab, tr)):
            np.testing.assert_array_equal(to_np(a), to_np(b))
            assert torch.equal(a[untouched], old[untouched])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["adam", "momentum"])
def test_hot_id_apply_rows_kernels_match_plain(cuda_device, name):
    """Two ``apply_rows`` calls on a stream where one id repeats 50,000
    times among Zipfian ids, each kernel held on the card to the inputs
    the call gave it, every row bit-exact, the hot row included:
    - K5: its unique ids equal the plain dedup's, and its sum of the hot
      row equals the float32 sum in K5's fixed order (the id's rows in
      stream order cut into pieces of 256 from its first, each piece
      summed in order, then the pieces in order), which numpy repeats;
    - K11/K12 on K5's own output, applied by the plain version to a copy
      of the state taken before the call (Adam's count as the call
      advanced it): slab and state equal."""
    from distributed_embeddings_torch.parallel import optimizers

    rng = np.random.default_rng(50)
    R, w, n, hot, chunk = 5000, 16, 120_000, 1234, 256
    ids = (rng.zipf(1.2, size=n) - 1) % R
    ids[rng.permutation(n)[:50_000]] = hot
    vals = rng.normal(size=(n, w)).astype(np.float32)
    rows = vals[ids == hot]
    cuts = np.r_[np.arange(0, len(rows), chunk), len(rows)]
    pieces = np.stack([np.add.accumulate(rows[a:b], dtype=np.float32)[-1]
                       for a, b in zip(cuts[:-1], cuts[1:])])
    hot_sum = np.add.accumulate(pieces, dtype=np.float32)[-1]
    tids = torch.from_numpy(ids.astype(np.int32)).to(cuda_device)
    tvals = torch.from_numpy(vals).to(cuda_device)
    slab = torch.from_numpy(rng.normal(size=(R, w)).astype(np.float32)
                            ).to(cuda_device)
    opt = SparseAdam() if name == "adam" else SparseMomentum(0.9)
    st = opt.init({"w": slab})["w"]
    real, calls = optimizers.dedup_sparse_grad, []

    def dedup(*args, **kw):
        calls.append(real(*args, **kw))
        return calls[-1]

    pu, _ = dedup_sparse_grad_plain(tids, tvals, pad_id=R, max_unique=R + 1)
    for _ in range(2):
        ws, old_hot = slab.clone(), slab[hot].clone()
        wst = tuple(t.clone() for t in st) if name == "adam" else st.clone()
        optimizers.dedup_sparse_grad = dedup
        try:
            slab, st = opt.apply_rows(slab, st, tids, tvals, 0.01)
        finally:
            optimizers.dedup_sparse_grad = real
        uids, uvals = calls[-1]
        assert torch.equal(uids, pu)
        assert int((uids == hot).sum()) == 1
        np.testing.assert_array_equal(to_np(uvals[uids == hot][0]), hot_sum)
        if name == "adam":
            assert float(st[2]) == float(wst[2]) + 1
            adam_rows_plain(ws, wst[0], wst[1], st[2], uids, uvals, 0.01,
                            opt.b1, opt.b2, opt.eps, opt.eps_root)
            got, want = (slab,) + st[:2], (ws,) + wst[:2]
        else:
            momentum_rows_plain(ws, wst, uids, uvals, 0.01, 0.9, False)
            got, want = (slab, st), (ws, wst)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(to_np(a), to_np(b))
        assert not torch.equal(slab[hot], old_hot)


@pytest.mark.cuda
def test_adam_zoo_train_on_the_card_matches_the_cpu(cuda_device):
    """The capped tiny zoo trained 3 steps with ``SparseAdam`` + ``Adam``
    on the card (K1, K5 + K11 per slab) and on the CPU (the plain
    versions) from one state, float32: losses within 1e-5 relative,
    moments within 1e-5, dense params within 1e-4; tables within 1e-4
    except where Adam's sign-like step turns a summed gradient within
    rounding of zero (K5 sums in pieces) into a step up to 2 lr the
    other way, at most 0.01% of the values."""
    cfg = synthetic_models_v3["tiny"]
    gen = InputGenerator(cfg, 128, alpha=1.05, num_batches=3, seed=4,
                         row_cap=500, device="cpu")
    out = {}
    for dev in ("cpu", cuda_device):
        de, dense, _ = build_synthetic(
            cfg, 1, row_cap=500, device=dev,
            generator=torch.Generator(device=dev).manual_seed(0))
        if dev == "cpu":
            init = de.init(torch.Generator().manual_seed(1), device="cpu")
            dense_init = {k: v.clone() for k, v in dense.state_dict().items()}
        dense.load_state_dict(dense_init)
        params = {k: v.clone().to(dev) for k, v in init.items()}
        state = HybridTrainState(
            emb_params=params, emb_opt_state=SparseAdam().init(params),
            dense_params=dense,
            dense_opt_state=Adam(0.01).init(list(dense.parameters())),
            step=torch.zeros((), dtype=torch.int32, device=dev))
        step = make_hybrid_train_step(de, _mse, Adam(0.01), SparseAdam(),
                                      lr_schedule=0.01)
        kernels = (dedup_sparse_grad, adam_rows, sgd_scatter, adagrad_rows)
        before = [k.launches for k in kernels]
        losses = []
        for k in range(3):
            n, c, y = gen[k]
            loss, state = step(state, [t.to(dev) for t in c],
                               (n.to(dev), y.to(dev)))
            losses.append(float(loss))
        launched = [k.launches - b for k, b in zip(kernels, before)]
        assert launched == ([0, 0, 0, 0] if dev == "cpu" else [6, 6, 0, 0])
        out[str(dev)] = (np.array(losses), de.get_weights(state.emb_params),
                         {k: [to_np(t) for t in v] for k, v in
                          state.emb_opt_state.items()},
                         [p.detach().cpu() for p in dense.parameters()])
    (lc, tc, ac, dc), (lg, tg, ag, dg) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    far = total = 0
    for a, b in zip(tg, tc):
        err = np.abs(a - b)
        assert (err <= 2 * 0.01 * 3).all()
        far += int((err > 1e-4).sum())
        total += err.size
    assert far <= total // 10_000, far
    for k in ac:
        for a, b in zip(ag[k][:2], ac[k][:2]):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(ag[k][2], ac[k][2])
    for a, b in zip(dg, dc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=0)


def _mse(dense, outs, batch):
    n, y = batch
    return torch.mean((dense(n, outs) - y) ** 2)


# ------------------------------------------------- K8-K10: the ragged path


def _csr(rng, n, b, max_hot, cap_frac=1.0, long_row=0):
    """``n`` slots of CSR rows: lengths ``[n, b]`` (some empty, one of
    ``long_row`` ids when given), splits ``[n, b + 1]`` int64, and the
    capacity ``cap_frac`` of the largest total (rows past it truncate)."""
    lengths = rng.integers(0, max_hot + 1, size=(n, b))
    lengths[:, 1 % b] = 0
    if long_row:
        lengths[0, 2] = long_row
    splits = np.zeros((n, b + 1), np.int64)
    np.cumsum(lengths, 1, out=splits[:, 1:])
    cap = max(1, int(splits[:, -1].max() * cap_frac))
    return lengths, splits, cap


@pytest.mark.cuda
def test_csr_kernels_match_plain(cuda_device):
    """K10: lengths -> splits (strided rows, dead slots), COO -> splits
    ([nnz, 2] and [nnz], int32/int64), positions -> rows (past the
    capacity too): bit-exact."""
    from distributed_embeddings_torch.ops import (
        lengths_to_splits, lengths_to_splits_plain, ragged_row_ids,
        ragged_row_ids_plain, row_to_split, row_to_split_plain)

    rng = np.random.default_rng(40)
    for n, b in ((1, 1), (3, 70), (26, 5000)):
        lengths, splits, cap = _csr(rng, n, b, 30)
        for dt in (torch.int32, torch.int64):
            block = torch.from_numpy(rng.integers(
                0, 9, size=(n, cap + b + 3))).to(dt).to(cuda_device)
            block[:, cap:cap + b] = torch.from_numpy(lengths).to(dt)
            view = block[:, cap:cap + b]
            for valid in (None, torch.from_numpy(
                    (np.arange(n) % 3 != 1).astype(np.int32)
                    ).to(cuda_device)):
                got = lengths_to_splits(view, valid)
                assert got.dtype == torch.int64
                assert torch.equal(got, lengths_to_splits_plain(view, valid))
        sp = torch.from_numpy(splits).to(cuda_device)
        for c in (1, cap // 2 + 1, cap + 5):
            for s in (sp, sp[0].contiguous()):
                for dt in (torch.int32, torch.int64):
                    x = s.to(dt)
                    got = ragged_row_ids(x, c)
                    assert got.dtype == dt
                    assert torch.equal(got, ragged_row_ids_plain(x, c))
        rows = np.concatenate([np.repeat(np.arange(b), lengths[0]),
                               [b, b + 3]])
        for dt in (torch.int32, torch.int64):
            r = torch.from_numpy(rows).to(dt).to(cuda_device)
            for idx in (r, torch.stack([r, torch.zeros_like(r)], 1)):
                for out_dt in (None, torch.int64):
                    got = row_to_split(idx, b, dtype=out_dt)
                    assert torch.equal(got, row_to_split_plain(idx, b,
                                                               out_dt))
    torch.cuda.synchronize()


def _poisoned(numel, dtype, dev):
    """Fill a block of the caching allocator with -7 and free it, so the
    next allocation of that size reuses stale memory."""
    t = torch.full((numel,), -7, dtype=dtype, device=dev)
    del t


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2047, 4097, 65536, 300001])
def test_csr_scan_over_tiles_matches_plain(cuda_device, b):
    """K10 lengths -> splits over slots of one to 74 scan tiles of 4,096
    (the decoupled look-back), int32 and int64 lengths, strided rows,
    dead slots, and a slot whose total passes 2^31: bit-exact. Then
    ``ragged_row_ids`` on those splits at capacities below and above the
    total."""
    from distributed_embeddings_torch.ops import (
        lengths_to_splits, lengths_to_splits_plain, ragged_row_ids,
        ragged_row_ids_plain)

    rng = np.random.default_rng(b)
    n = 5 if b <= 65536 else 2
    for dt in (torch.int32, torch.int64):
        lengths = rng.integers(0, 31, size=(n, b))
        lengths[0, : b // 2] = 0                      # a long empty run
        big = (2 ** 30 + 12345) if dt == torch.int32 else 3 * 2 ** 40
        lengths[-1, ::max(1, b // 7)] = big           # total past 2^31
        block = torch.from_numpy(rng.integers(0, 9, size=(n, 2 * b + 3))
                                 ).to(dt).to(cuda_device)
        block[:, 3:b + 3] = torch.from_numpy(lengths).to(dt)
        for view in (block[:, 3:b + 3], block[:, 3:b + 3].contiguous()):
            for valid in (None, torch.from_numpy(
                    (np.arange(n) % 2 == 0).astype(np.int32)
                    ).to(cuda_device)):
                _poisoned(n * (b + 1), torch.int64, cuda_device)
                got = lengths_to_splits(view, valid)
                want = lengths_to_splits_plain(view, valid)
                assert got.dtype == torch.int64
                assert torch.equal(got, want)
                if valid is None and (dt == torch.int64 or b > 2):
                    assert int(want[-1, -1]) > 2 ** 31
    small = torch.from_numpy(rng.integers(0, 31, size=(n, b))).to(
        cuda_device)
    sp = lengths_to_splits(small)
    total = int(sp[:, -1].max())
    for cap in (1, max(1, total // 3), total, total + 4097):
        for s in (sp, sp[0].contiguous(), sp.to(torch.int32)):
            got = ragged_row_ids(s, cap)
            assert got.dtype == s.dtype
            assert torch.equal(got, ragged_row_ids_plain(s, cap))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", [torch.int32, torch.int64])
def test_csr_row_to_split_edges_match_plain(cuda_device, dt):
    """K10 ``row_to_split`` bit-exact over 2.4M COO entries with long
    empty runs, negative rows and padding rows past ``dim_0``, at
    ``nnz`` 0 and 1 and all rows past ``dim_0``; on rows that do not
    ascend (outside the contract) every entry is written, with a value
    in ``[0, nnz]``, over a poisoned allocation."""
    from distributed_embeddings_torch.ops import row_to_split, \
        row_to_split_plain

    rng = np.random.default_rng(3)
    dim0 = 65536
    counts = rng.integers(0, 150, size=dim0)
    counts[1000:30000] = 0                            # a long empty run
    counts[-5000:] = 0
    rows = np.concatenate([np.full(777, -3), [-1],
                           np.repeat(np.arange(dim0), counts),
                           np.full(1234, dim0), [dim0 + 5, 2 ** 30]])
    assert rows.size > 2_000_000
    cases = {"long": rows, "empty": rows[:0], "one": np.array([7]),
             "one_negative": np.array([-2]),
             "all_past": np.full(3000, dim0 + 1)}
    for what, r in cases.items():
        t = torch.from_numpy(r).to(dt).to(cuda_device)
        for idx in (t, torch.stack([t, torch.zeros_like(t)], 1)):
            for d0 in (dim0, 5):
                for out_dt in (None, torch.int64, torch.int32):
                    got = row_to_split(idx, d0, dtype=out_dt)
                    want = row_to_split_plain(idx, d0, out_dt)
                    assert torch.equal(got, want), (what, d0, out_dt)
    shuffled = torch.from_numpy(rng.permutation(rows[:300000])).to(dt).to(
        cuda_device)
    for d0 in (dim0, 100):
        _poisoned(d0 + 1, torch.int64, cuda_device)
        got = row_to_split(shuffled, d0, dtype=torch.int64)
        torch.cuda.synchronize()
        assert got.shape == (d0 + 1,)
        assert int(got.min()) >= 0 and int(got.max()) <= shuffled.shape[0]


def _ragged_block(rng, n, b, vocab, max_hot, ids_dt, cap_frac=1.0,
                  long_row=0, weights="none"):
    """An id block ``[n, cap + b + cap]`` as the lookup reads it:
    values (with negative and past-the-table ids, padding holding id 0),
    lengths, then float32 weight bits (``weights``: ``"none"``,
    ``"f32"`` a separate float32 tensor, ``"bits"`` in the block)."""
    lengths, splits, cap = _csr(rng, n, b, max_hot, cap_frac, long_row)
    vals = rng.integers(-3, vocab + 3, size=(n, cap))
    for k in range(n):
        vals[k, min(splits[k, -1], cap):] = 0
    w = rng.uniform(0.25, 2.0, size=(n, cap)).astype(np.float32)
    block = np.concatenate([vals, lengths,
                            w.view(np.int32).astype(np.int64)], 1)
    block = torch.from_numpy(block).to(ids_dt)
    wt = None
    if weights == "f32":
        wt = torch.from_numpy(w)
    elif weights == "bits":
        wt = block[:, cap + b:]
    return block, cap, torch.from_numpy(splits), wt


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("width", [3, 8, 16, 128])
def test_ragged_combine_kernel_matches_plain(cuda_device, dtype, out_dtype,
                                             width):
    """K8 against its plain version, bit-exact (both add in float32 in
    position order with the same roundings): sum and mean slots, no /
    float32 / in-block (int32 and int64) weights, clipped and masked bad
    ids, empty rows, rows past the capacity and a row of 1,500 ids."""
    from distributed_embeddings_torch.ops import (ragged_combine,
                                                  ragged_combine_plain)

    rng = np.random.default_rng(width)
    n, b, vocab = 3, 60, 50
    slab = torch.from_numpy(rng.normal(size=(n * vocab, width))
                            .astype(np.float32)).to(dtype).to(cuda_device)
    meta = dict(
        rows=torch.full((n,), vocab, dtype=torch.int64, device=cuda_device),
        roff=torch.arange(n, dtype=torch.int64, device=cuda_device) * vocab)
    for ids_dt in (torch.int32, torch.int64):
        for frac, long_row in ((1.0, 0), (0.6, 0), (1.0, 1500)):
            for wkind in ("none", "f32", "bits"):
                block, cap, splits, wt = _ragged_block(
                    rng, n, b, vocab, 6, ids_dt, frac, long_row, wkind)
                block = block.to(cuda_device)
                values = block[:, :cap]
                wt = None if wt is None else (
                    block[:, cap + b:] if wkind == "bits"
                    else wt.to(cuda_device))
                for mean, mask in (((0, 1, 0), None), ((1, 0, 1), (0, 1, 1))):
                    kw = dict(meta, splits=splits.to(cuda_device),
                              mean=torch.tensor(mean, dtype=torch.int32,
                                                device=cuda_device),
                              mask=None if mask is None else torch.tensor(
                                  mask, dtype=torch.int32,
                                  device=cuda_device),
                              weights=wt, out_dtype=out_dtype)
                    got = ragged_combine(slab, values, **kw)
                    want = ragged_combine_plain(slab, values, **kw)
                    assert got.dtype == out_dtype
                    assert torch.equal(got, want), (
                        f"{ids_dt} frac={frac} long={long_row} {wkind} "
                        f"mean={mean}: max err "
                        f"{float((got.float() - want.float()).abs().max())}")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [3, 8, 16, 128])
def test_ragged_grad_kernel_matches_plain(cuda_device, dtype, width):
    """K9 against its plain version, bit-exact (the same rounding after
    each op): ids with the sentinel for bad ids, padding and positions
    past the rows, rows past the capacity, a row of 1,500 ids, weights,
    mean slots by division and by reciprocal, a cotangent read through
    strided rows, and every position written (the outputs start as
    garbage)."""
    from distributed_embeddings_torch.ops import ragged_grad, ragged_grad_plain

    rng = np.random.default_rng(100 + width)
    n, b, vocab = 3, 60, 50
    # cotangent rows as the apply reads them: [n, b, w] through a
    # [b, n * w + 5]-strided block
    gblock = torch.from_numpy(rng.normal(size=(b, n * width + 8))
                              .astype(np.float32)).to(dtype).to(cuda_device)
    g = gblock[:, :n * width].reshape(b, n, width).transpose(0, 1)
    meta = dict(
        rows=torch.full((n,), vocab, dtype=torch.int64, device=cuda_device),
        roff=torch.arange(n, dtype=torch.int64, device=cuda_device) * vocab)
    for ids_dt in (torch.int32, torch.int64):
        for frac, long_row in ((1.0, 0), (0.6, 0), (1.0, 1500)):
            for wkind in ("none", "bits"):
                block, cap, splits, wt = _ragged_block(
                    rng, n, b, vocab, 6, ids_dt, frac, long_row, wkind)
                block = block.to(cuda_device)
                wt = None if wt is None else block[:, cap + b:]
                for mean, recip in (((0, 1, 1), False), ((1, 1, 0), True)):
                    kw = dict(splits=splits.to(cuda_device),
                              values=block[:, :cap], sentinel=n * vocab + 7,
                              ids_dtype=ids_dt, weights=wt,
                              mean=torch.tensor(mean, dtype=torch.int32,
                                                device=cuda_device),
                              reciprocal=recip, **meta)
                    torch.cuda.empty_cache()
                    gi, gv = ragged_grad(g, **kw)
                    wi, wv = ragged_grad_plain(g, cap=cap, **kw)
                    assert torch.equal(gi, wi)
                    assert torch.equal(gv, wv), (
                        f"{ids_dt} frac={frac} {wkind} mean={mean}")
    # no ids: the op-level combiner_grad_values form
    _, gv = ragged_grad(g, splits.to(cuda_device), cap=cap + 9)
    _, wv = ragged_grad_plain(g, splits.to(cuda_device), cap=cap + 9)
    assert torch.equal(gv, wv)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_ragged_grad_kernel_past_2_31_elements(cuda_device):
    """K9 writing a stream of more than 2^31 elements (one slot, ~19.2M
    positions of 128 bf16): element offsets must be 64-bit. The rows
    and ids past element 2^31, and a sample before it, match the plain
    version bit for bit."""
    from distributed_embeddings_torch.ops import ragged_grad, ragged_grad_plain

    b, w, hot = 1 << 20, 128, 18
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    lengths = torch.randint(hot - 4, hot + 5, (1, b), generator=gen,
                            device=cuda_device)
    splits = torch.zeros((1, b + 1), dtype=torch.int64, device=cuda_device)
    splits[0, 1:] = torch.cumsum(lengths[0], 0)
    cap = int(splits[0, -1]) + 300_000
    assert cap * w > 2 ** 31
    values = torch.randint(-2, 1000, (1, cap), generator=gen,
                           device=cuda_device, dtype=torch.int32)
    g = torch.randn((1, b, w), generator=gen, device=cuda_device
                    ).to(torch.bfloat16)
    kw = dict(values=values, rows=torch.tensor([990], device=cuda_device),
              roff=torch.tensor([5], device=cuda_device), sentinel=10 ** 6,
              mean=torch.ones(1, dtype=torch.int32, device=cuda_device))
    ids, vals = ragged_grad(g, splits, **kw)
    torch.cuda.synchronize()
    # the plain version on the last rows (their positions lie past 2^31
    # elements) and on the first ones
    for lo_row, hi_row in ((0, 1000), (b - 100_000, b)):
        sp = splits[:, lo_row:hi_row + 1]
        p0 = int(sp[0, 0])
        p1 = cap if hi_row == b else int(sp[0, -1])
        sub = dict(kw, values=values[:, p0:p1])
        wi, wv = ragged_grad_plain(g[:, lo_row:hi_row], sp - p0,
                                   cap=p1 - p0, **sub)
        assert torch.equal(ids[:, p0:p1], wi)
        assert torch.equal(vals[:, p0:p1], wv)
    assert p0 * w > 2 ** 31


@pytest.mark.cuda
def test_ragged_train_step_on_the_card_matches_the_cpu(cuda_device):
    """A small float32 DLRM on ragged inputs (a mean table, a weighted
    input, bad ids) trained 5 steps on the card (K8-K10, K2-K4) and on
    the CPU (their plain versions) from one state: losses, tables and
    dense params within 1e-4 (cuBLAS and the CPU sum in other orders);
    a SparseIds twin of the first batch gives the same forward."""
    from distributed_embeddings_torch import Ragged, SparseIds
    from distributed_embeddings_torch.ops import (
        lengths_to_splits, ragged_combine, ragged_grad, row_to_split)

    sizes = [500, 7, 33, 1200]
    cfg = DLRMConfig(table_sizes=sizes, embedding_dim=16,
                     num_numerical_features=13, bottom_mlp_dims=(32, 16),
                     top_mlp_dims=(64, 1))
    configs = cfg.embedding_configs(combiner="sum")
    configs[2]["combiner"] = "mean"
    de = DistributedEmbedding(configs, world_size=1)
    params = de.init(torch.Generator().manual_seed(0), device="cpu")
    dense = DLRMDense(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(1))

    def loss_fn(m, outs, batch):
        return bce_with_logits(m(batch[0], outs), batch[1])

    rng = np.random.default_rng(3)
    B = 256

    def ragged(v, t):
        lengths = rng.integers(1, 8, size=B)
        splits = np.zeros(B + 1, np.int32)
        np.cumsum(lengths, out=splits[1:])
        ids = _ids(rng, v, (7 * B,))
        w = rng.uniform(0.5, 1.5, 7 * B).astype(np.float32)
        return (ids, splits, w if t == 1 else None)

    batches = [([ragged(s, t) for t, s in enumerate(sizes)],
                rng.normal(size=(B, 13)).astype(np.float32),
                (rng.random(B) < 0.3).astype(np.float32)) for _ in range(5)]

    def to(c, dev):
        return Ragged(values=torch.from_numpy(c[0]).to(dev),
                      row_splits=torch.from_numpy(c[1]).to(dev),
                      weights=None if c[2] is None
                      else torch.from_numpy(c[2]).to(dev))

    kernels = (ragged_combine, lengths_to_splits, ragged_grad, sgd_scatter,
               dot_interact_fwd, dot_interact_bwd, gather_combine)
    out = {}
    for dev in ("cpu", cuda_device):
        d = DLRMDense(cfg, device=dev)
        d.load_state_dict(dense.state_dict())
        state = HybridTrainState(
            emb_params={k: v.clone().to(dev) for k, v in params.items()},
            emb_opt_state=SparseSGD().init(params), dense_params=d,
            dense_opt_state=(),
            step=torch.zeros((), dtype=torch.int32, device=dev))
        step = make_hybrid_train_step(de, loss_fn, SGD(0.1), SparseSGD(),
                                      lr_schedule=0.1)
        before = [k.launches for k in kernels]
        losses = []
        for cats, num, lab in batches:
            loss, state = step(state, [to(c, dev) for c in cats],
                               (torch.from_numpy(num).to(dev),
                                torch.from_numpy(lab).to(dev)))
            losses.append(float(loss))
        launched = [k.launches - b for k, b in zip(kernels, before)]
        # two ragged groups ("r" and "rw") a step: K8 and K9 twice, K10
        # four times (forward and backward); one slab: K3 once
        assert launched == ([0] * 7 if dev == "cpu"
                            else [10, 20, 10, 5, 5, 5, 0])
        if dev != "cpu":
            cats = [to(c, dev) for c in batches[0][0]]
            sparse = []
            for c in cats:
                rows = torch.repeat_interleave(
                    torch.arange(B, device=dev),
                    (c.row_splits[1:] - c.row_splits[:-1]).long())
                rows = torch.cat([rows, torch.full(
                    (c.values.shape[0] - rows.shape[0],), B, device=dev)])
                sparse.append(SparseIds(
                    indices=torch.stack([rows, torch.zeros_like(rows)], 1),
                    values=c.values, dense_shape=(B, 7), weights=c.weights))
            n0 = row_to_split.launches
            for a, s in zip(de(state.emb_params, cats),
                            de(state.emb_params, sparse)):
                assert torch.equal(a, s)
            assert row_to_split.launches - n0 == len(sizes)
        out[str(dev)] = (losses, de.get_weights(state.emb_params),
                         [p.detach().cpu() for p in d.parameters()])
    (lc, tc, dc), (lg, tg, dg) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_allclose(lg, lc, atol=1e-4, rtol=0)
    for a, b in zip(tg, tc):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    for a, b in zip(dg, dc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=0)


# ---------------------------------------- wrapped rows in K6, K11, K12


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["wrapped", "with_id0"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["adagrad", "momentum", "nesterov", "adam"])
def test_wrapped_row_kernels_match_plain(cuda_device, name, dtype, stream):
    """A negative id beside its wrapped row (and, in ``with_id0``, id 0
    beside -R, which wraps to row 0) in one sorted unique stream: K6,
    K11 and K12 against their plain versions, slab and state bit-exact
    (the plain versions hold JAX's order, ``test_torch_wrapped_rows.py``;
    the kernels run the negative ids in a pass of their own first)."""
    rng = np.random.default_rng(len(name) + 10 * (stream == "with_id0"))
    R, w = 64, 16
    ids = {"wrapped": [-R - 2, -R, -5, -3, 7, 12, R - 3, R, R],
           "with_id0": [-R, -9, -3, 0, 11, 40, R - 9, R - 3, R]}[stream]
    uids = torch.tensor(ids, dtype=torch.int32, device=cuda_device)
    g = torch.from_numpy(rng.normal(size=(len(ids), w)).astype(
        np.float32)).to(dtype).to(cuda_device)
    slab = torch.from_numpy(rng.normal(size=(R, w)).astype(np.float32)).to(
        dtype).to(cuda_device)
    state = [torch.from_numpy((0.05 + 0.2 * rng.random((R, w))).astype(
        np.float32)).to(dtype).to(cuda_device)
        for _ in range(2 if name == "adam" else 1)]
    runs = []
    for fn in ("kernel", "plain"):
        s, st = slab.clone(), [t.clone() for t in state]
        if name == "adagrad":
            (adagrad_rows if fn == "kernel" else adagrad_rows_plain)(
                s, st[0], uids, g, 0.1, 1e-7)
        elif name == "adam":
            cnt = torch.full((1, 1), 7.0, device=cuda_device)
            (adam_rows if fn == "kernel" else adam_rows_plain)(
                s, st[0], st[1], cnt, uids, g, 0.1, 0.9, 0.999, 1e-8, 0.0)
        else:
            (momentum_rows if fn == "kernel" else momentum_rows_plain)(
                s, st[0], uids, g, 0.1, 0.9, name == "nesterov")
        runs.append([s] + st)
    for a, b in zip(*runs):
        np.testing.assert_array_equal(to_np(a), to_np(b))
    assert not torch.equal(runs[0][0][R - 3], slab[R - 3])


# -------------------------------------------------- K13-K15: telemetry


def _telemetry_ids(rng, n, kind):
    """``(ids, live)`` of a telemetry stream: ``zipf`` (Zipfian over 200K
    rows, ~10% dead), ``zipf19`` (the ragged stream's ~19 positions a
    distinct live id), ``edges`` (``zipf`` with 2% negative ids and 1%
    ``INT32_MAX``, live and dead), ``spread`` (ids over all of int32, a
    few repeated), ``distinct`` (every position live, no two alike)."""
    if kind == "distinct":
        ids = rng.permutation(4 * n)[:n] - 2 * n
        return ids.astype(np.int32), np.ones(n, bool)
    if kind == "spread":
        ids = rng.integers(-2 ** 31, 2 ** 31 - 1, n)
        again = rng.random(n) < 0.3
        ids[again] = ids[:64][rng.integers(0, 64, int(again.sum()))]
    elif kind == "zipf19":
        ids = (rng.zipf(1.25, n) - 1) % 200_000
    else:
        ids = (rng.zipf(1.2, n) - 1) % 200_000
    if kind == "edges":  # negative ids score id 0's count: make it ~80th
        u = rng.random(n)
        ids = np.where(u < 0.02, -rng.integers(1, 5000, n), ids + 1)
        ids = np.where((u > 0.02) & (u < 0.021), 0, ids)
        ids = np.where(u > 0.99, 2 ** 31 - 1, ids)
        ids[0] = 2 ** 31 - 1
    live = rng.random(n) < 0.9
    if kind == "edges":
        live[0] = True  # the first pad-valued position is a live one
    return ids.astype(np.int32), live


def _telemetry_case(rng, n, depth, buckets, topk, device, kind="zipf"):
    """A stream of ``_telemetry_ids`` and a prior state (a nonzero
    sketch, some carried hot rows)."""
    ids, live = _telemetry_ids(rng, n, kind)
    cms = rng.integers(0, 9, (depth, buckets)).astype(np.int32)
    tids = np.full(topk, -1, np.int32)
    tids[:topk // 2] = rng.permutation(max(50, topk // 2))[:topk // 2]
    test = np.where(tids >= 0, rng.integers(1, 30, topk), 0).astype(np.int32)
    wstate = {"cms": torch.from_numpy(cms).to(device),
              "topk_ids": torch.from_numpy(tids).to(device),
              "topk_est": torch.from_numpy(test).to(device),
              "ids": torch.tensor([123.0], device=device)}
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(live).to(device), wstate)


def _sketch_case(n, depth, buckets, topk, cand, kind="zipf"):
    return pytest.param(n, depth, buckets, topk, cand, kind,
                        id=f"{n}-{depth}-{buckets}-{topk}-{cand}"
                        + ("" if kind == "zipf" else f"-{kind}"))


@pytest.mark.cuda
@pytest.mark.parametrize("n,depth,buckets,topk,cand,kind", [
    _sketch_case(425_984, 4, 2048, 32, 128),  # the DLRM telemetry stream
    _sketch_case(5_000, 3, 61, 6, 10),
    _sketch_case(1_000, 9, 3, 4, 7),          # depths past 8, 3 buckets
    _sketch_case(50, 4, 2048, 32, 128),       # n < candidates
    _sketch_case(100_000, 16, 8192, 32, 128),  # 512 KB: no shared copy
    _sketch_case(300_000, 4, 2047, 64, 4096),  # several tournament rounds
    _sketch_case(2_600_000, 4, 2048, 32, 128, "zipf19"),  # ragged-like
    _sketch_case(200_000, 4, 2048, 32, 128, "edges"),  # < 0, INT32_MAX
    _sketch_case(1_000_000, 4, 2048, 32, 128, "spread"),  # probing
    _sketch_case(300_000, 4, 2048, 32, 0, "zipf"),  # cand: the pool max
    _sketch_case(2_000_000, 4, 2048, 32, 128, "distinct"),  # a full set
    # past shared memory (C5): topk 2048 with its default 8192 candidates
    # (the pool in the tile, the merge in device memory), and candidates
    # past the tile (both in device memory), one with INT32_MAX ids
    _sketch_case(2_600_000, 4, 2048, 2048, 8192, "zipf19"),
    _sketch_case(1_000_000, 4, 2048, 32, 16384, "spread"),
    _sketch_case(200_000, 4, 2048, 64, 20000, "edges"),
])
def test_sketch_kernels_match_plain(cuda_device, n, depth, buckets, topk,
                                    cand, kind):
    """K13 (sketch update and live count), K14 (query and candidate
    pool) and K15 (top-k merge) against their plain versions on the
    card, three steps from one prior state: every leaf bit-exact.
    ``cand`` 0 takes the largest pool the shared-memory tile holds (the
    merge is left out); the C5 cases run past the tile, in device
    memory."""
    from distributed_embeddings_torch.ops import sketch as sk

    merge = cand > 0
    if not merge:
        cand = sk._pool_max()
        assert cand >= 4096
    elif topk == 2048:
        assert sk.pool_path(min(cand, n)) == "tile"
        assert sk.merge_path(topk, cand) == "device"
    elif cand > 8192:
        assert sk.pool_path(min(cand, n)) == "device"
        assert sk.merge_path(topk, cand) == "device"
    runs = []
    for use_kernels in (True, False):
        rng = np.random.default_rng(n + depth)
        ids, live, ws = _telemetry_case(rng, n, depth, buckets, topk,
                                        cuda_device, kind)
        outs = []
        for step in range(3):
            if step:
                ids = ids[torch.randperm(n, device=cuda_device,
                                         generator=torch.Generator(
                                             cuda_device).manual_seed(step))]
            if use_kernels:
                before = (sk.cms_update.launches, sk.topk_pool.launches,
                          sk.topk_merge.launches)
                counts = sk.cms_update(ws["cms"], ids, live)
                pool = sk.topk_pool(ws["cms"], ids, live, min(cand, n))
                cnt = sk.topk_merge(ws["cms"], pool, counts, ws["topk_ids"],
                                    ws["topk_est"], ws["ids"], cand) \
                    if merge else counts.sum()
                assert (sk.cms_update.launches, sk.topk_pool.launches,
                        sk.topk_merge.launches) == tuple(
                            b + (1 if i < 2 or merge else 0)
                            for i, b in enumerate(before))
                est = sk.cms_query(ws["cms"], ids)
            else:
                counts = sk.cms_update_plain(ws["cms"], ids, live)
                pool = sk.topk_pool_plain(ws["cms"], ids, live,
                                          min(cand, n))
                cnt = sk.topk_merge_plain(ws["cms"], pool, counts,
                                          ws["topk_ids"], ws["topk_est"],
                                          ws["ids"], cand) \
                    if merge else counts.sum()
                est = sk.cms_query_plain(ws["cms"], ids)
            outs.append([int(counts.sum()), pool.clone(), cnt.clone(),
                         est] + [v.clone() for v in ws.values()])
        runs.append(outs)
    for step, (a, b) in enumerate(zip(*runs)):
        assert a[0] == b[0] == int(live.sum()), step
        for x, y in zip(a[1:], b[1:]):
            np.testing.assert_array_equal(to_np(x), to_np(y),
                                          err_msg=f"step {step}")
    assert (runs[0][-1][-3] >= 0).any() or not merge  # hot rows found
    assert (runs[0][-1][1] != sk.PAD).any()  # a pool of live ids


def _remap_case(rng, n, rows_cap, cap, is64, dev):
    """A width stream over three streaming tables of capacity ``cap``
    (buckets cap // 4 + 1) stacked from slab row 0: Zipfian external ids
    (int64 ones past 2^32 when ``is64``), 5% dead and 2% negative."""
    nt = 3
    nb = cap // 4 + 1
    assert nt * (cap + nb) <= rows_cap
    t = rng.integers(0, nt, n)
    ext = 10 ** 6 + (rng.zipf(1.2, n) - 1) % (8 * cap + 8)
    if is64:
        ext = ext + (rng.integers(0, 3, n) << 32)
    ext = np.where(rng.random(n) < 0.02, -rng.integers(1, 9, n), ext)
    live = rng.random(n) >= 0.05

    def t32(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(
            np.int32)).to(dev)

    return (torch.from_numpy(ext.astype(np.int64 if is64 else np.int32)
                             ).to(dev), torch.from_numpy(live).to(dev),
            t32(np.full(n, cap)), t32(np.full(n, nb)), t32(t + 7),
            t32(t * (cap + nb)))


@pytest.mark.cuda
@pytest.mark.parametrize("is64", [False, True])
@pytest.mark.parametrize("n,rows_cap,cap,admit,margin", [
    (1, 8, 1, 1, 0),
    (5_000, 4_096, 1_000, 2, 1),
    (20_000, 64, 1, 1, 1),            # one slot a table: heavy contention
    (300_000, 1 << 20, 200_000, 2, 0),
])
def test_streaming_kernels_match_plain(cuda_device, n, rows_cap, cap, admit,
                                       margin, is64):
    """K16 (remap and stage, update and read-only) and K17 (commit)
    against their plain versions on the card, four steps from one prior
    state with a fifth disabled: every output and leaf bit-exact (NaN
    equals NaN)."""
    from distributed_embeddings_torch.ops import streaming as so

    runs = []
    for use_kernels in (True, False):
        rng = np.random.default_rng(n + cap)
        dev = cuda_device
        slot_fp = torch.full((rows_cap,), -1, dtype=torch.int32, device=dev)
        slot_freq = torch.zeros(rows_cap, dtype=torch.int32, device=dev)
        cms = torch.zeros((4, 4096), dtype=torch.int32, device=dev)
        slab = torch.from_numpy(rng.normal(size=(rows_cap, 16)).astype(
            np.float32)).to(dev)
        slab[::5, 2] = float("inf")
        acc = torch.full_like(slab, 0.7)
        totals = torch.zeros(4, device=dev)
        counters = [torch.zeros(1, device=dev) for _ in range(4)]
        steps = torch.zeros(1, dtype=torch.int32, device=dev)
        outs = []
        for step in range(5):
            s = _remap_case(rng, n, rows_cap, cap, is64, dev)
            staged = cms.clone()
            remap = so.remap_stage if use_kernels else so.remap_stage_plain
            commit = so.commit_rows if use_kernels else so.commit_rows_plain
            before = (so.remap_stage.launches, so.commit_rows.launches)
            ro = remap(*s, slot_fp, slot_freq, None, admit, margin,
                       update=False)
            r = remap(*s, slot_fp, slot_freq, staged, admit, margin)
            en = None if step < 3 else torch.tensor(step == 3, device=dev)
            commit(slab, [(acc, 0.1)], r, slot_fp, slot_freq, cms, staged,
                   totals, counters, steps, enable=en)
            assert (so.remap_stage.launches, so.commit_rows.launches) == (
                (before[0] + 2, before[1] + 1) if use_kernels else before)
            outs.append([ro.local_rows] + list(r) + [
                slot_fp.clone(), slot_freq.clone(), cms.clone(),
                slab.clone(), acc.clone(), totals.clone(), steps.clone()]
                + [c.clone() for c in counters])
        runs.append(outs)
    for step, (a, b) in enumerate(zip(*runs)):
        for k, (x, y) in enumerate(zip(a, b)):
            np.testing.assert_array_equal(to_np(x), to_np(y),
                                          err_msg=f"step {step} output {k}")
        assert torch.equal(a[0], a[1])  # read-only rows equal update's
    counts = runs[0][-1][-4:]
    assert float(counts[0]) > 0  # admissions
    assert n == 1 or float(counts[3]) > 0  # hits
    assert int(runs[0][-1][-5]) == 4  # the disabled step did not count


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["adagrad_bf16", "adam", "momentum"])
def test_streaming_commit_kernel_resets_leaves(cuda_device, opt):
    """K17 on a bf16 slab with fp32 accumulators, Adam's mu/nu and a
    momentum trace (claims on free and occupied rows, an Inf row, a row
    both hit and claimed): bit-exact to its plain version."""
    from distributed_embeddings_torch.ops import streaming as so

    dev = cuda_device
    rng = np.random.default_rng(len(opt))
    rows, w, n = 512, 24, 4_000
    dt = torch.bfloat16 if opt == "adagrad_bf16" else torch.float32
    fills = {"adagrad_bf16": [0.1], "adam": [0.0, 0.0], "momentum": [0.0]}
    res = []
    for use_kernel in (True, False):
        g = torch.Generator(dev).manual_seed(3)
        slab = torch.randn(rows, w, generator=g, device=dev).to(dt)
        slab[8] = float("inf")
        leaves = [(torch.rand(rows, w, generator=g, device=dev) + 0.5, f)
                  for f in fills[opt]]
        fp = torch.randint(0, 2 ** 31 - 1, (n,), generator=g, device=dev,
                           dtype=torch.int32)
        est = torch.randint(0, 50, (n,), generator=g, device=dev,
                            dtype=torch.int32)
        scrub = torch.full((n,), rows, dtype=torch.int32, device=dev)
        scrub[:rows:2] = torch.arange(0, rows, 2, dtype=torch.int32,
                                      device=dev)[torch.randperm(
                                          rows // 2, generator=g,
                                          device=dev)]
        hit = torch.randint(0, rows + 40, (n,), generator=g, device=dev,
                            dtype=torch.int32)
        counts = torch.tensor([rows // 2, 9, 100, 30], device=dev)
        r = so.Remap(torch.zeros(n, dtype=torch.int32, device=dev), fp, est,
                     scrub, hit, counts)
        slot_fp = torch.full((rows,), -1, dtype=torch.int32, device=dev)
        slot_freq = torch.randint(0, 20, (rows,), generator=g, device=dev,
                                  dtype=torch.int32)
        cms = torch.zeros((4, 64), dtype=torch.int32, device=dev)
        staged = torch.randint(0, 9, (4, 64), generator=g, device=dev,
                               dtype=torch.int32)
        totals = torch.zeros(4, device=dev)
        counters = [torch.ones(1, device=dev) for _ in range(4)]
        steps = torch.zeros(1, dtype=torch.int32, device=dev)
        (so.commit_rows if use_kernel else so.commit_rows_plain)(
            slab, leaves, r, slot_fp, slot_freq, cms, staged, totals,
            counters, steps, enable=torch.tensor(True, device=dev))
        res.append([slab, *[t for t, _ in leaves], slot_fp, slot_freq, cms,
                    totals, steps, *counters])
    for x, y in zip(*res):
        np.testing.assert_array_equal(to_np(x), to_np(y))
    claimed = to_np(res[0][0][0:rows:2])
    assert np.isnan(claimed[4]).all()  # the Inf row: x + (-x) is NaN
    assert (np.delete(claimed, 4, axis=0) == 0).all()


@pytest.mark.cuda
def test_streaming_train_step_on_the_card_matches_the_cpu(cuda_device):
    """Four guarded SparseAdagrad steps of a small streaming model (a
    static and a streaming table in one group, a streaming multi-hot
    table), the third a NaN batch, on the card (K16, K13, K17) and on the
    CPU (plain versions) from one state: the streaming state bitwise,
    losses, slabs and accumulators within 1e-4."""
    from distributed_embeddings_torch.parallel import (
        StreamingConfig, init_streaming)

    cfgs = [{"input_dim": 500, "output_dim": 16},
            {"input_dim": 3000 + 200, "output_dim": 16,
             "streaming": {"capacity": 3000, "buckets": 200}},
            {"input_dim": 800 + 64, "output_dim": 16, "combiner": "sum",
             "streaming": {"capacity": 800, "buckets": 64}}]
    scfg = StreamingConfig(2, 1, 4, 1024)
    rng = np.random.default_rng(8)
    b = 2048
    batches = []
    for k in range(4):
        ext = 10 ** 7 + (rng.zipf(1.2, (b, 4)) - 1) % 20_000
        y = rng.normal(size=b).astype(np.float32)
        if k == 2:
            y[0] = np.nan
        batches.append(([rng.integers(0, 500, b).astype(np.int32),
                         ext[:, 0].astype(np.int64),
                         ext[:, 1:].astype(np.int64)], y))
    runs = []
    for dev in (cuda_device, torch.device("cpu")):
        de = DistributedEmbedding(cfgs, world_size=1)
        params = de.init(torch.Generator().manual_seed(0), device="cpu")
        params = {k: v.to(dev) for k, v in params.items()}
        lin = torch.nn.Linear(48, 1).to(dev)
        with torch.no_grad():
            lin.weight.copy_(torch.linspace(-1, 1, 48, device=dev)[None])
            lin.bias.zero_()
        opt = SparseAdagrad()
        st = HybridTrainState(params, opt.init(params), lin,
                              SGD(0.05).init(list(lin.parameters())),
                              torch.zeros((), dtype=torch.int32, device=dev))

        def loss_fn(m, outs, y):
            x = torch.cat([o.reshape(o.shape[0], -1) for o in outs], 1)
            return torch.mean((m(x)[:, 0] - y) ** 2)

        step = make_hybrid_train_step(de, loss_fn, SGD(0.05), opt,
                                      lr_schedule=0.05, nan_guard=True,
                                      dynamic=scfg)
        ss = init_streaming(de, scfg, device=dev)
        losses = []
        for cats, y in batches:
            loss, st, ss = step(st, [torch.from_numpy(c).to(dev)
                                     for c in cats],
                                torch.from_numpy(y).to(dev), ss)
            losses.append(float(loss))
        runs.append((losses, st, ss))
    (lk, sk, ssk), (lp, sp, ssp) = runs
    np.testing.assert_allclose(lk, lp, rtol=1e-4, atol=1e-6)
    for k in ("steps", "admitted", "evicted", "bucket_ids", "hit_ids"):
        np.testing.assert_array_equal(to_np(ssk[k]), to_np(ssp[k]))
    for k in ("slot_fp", "slot_freq", "cms"):
        np.testing.assert_array_equal(to_np(ssk["w16"][k]),
                                      to_np(ssp["w16"][k]))
    np.testing.assert_allclose(to_np(sk.emb_params["w16"]),
                               to_np(sp.emb_params["w16"]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(to_np(sk.emb_opt_state["w16"]),
                               to_np(sp.emb_opt_state["w16"]), rtol=1e-4,
                               atol=1e-5)
    assert float(ssk["admitted"][0, 0]) > 0 and int(ssk["steps"][0, 0]) == 3


def _bf16_bits_equal(got: torch.Tensor, want: torch.Tensor, what: str):
    """Bitwise bfloat16 equality, a NaN matching any NaN."""
    g = got.detach().cpu().view(torch.int16).numpy().view(np.uint16)
    w = want.detach().cpu().view(torch.int16).numpy().view(np.uint16)
    gnan, wnan = (g & 0x7FFF) > 0x7F80, (w & 0x7FFF) > 0x7F80
    np.testing.assert_array_equal(gnan, wnan, err_msg=what)
    bad = (g != w) & ~gnan
    assert not bad.any(), f"{what}: {int(bad.sum())} elements differ"


@pytest.mark.cuda
@pytest.mark.parametrize("vals_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [3, 16, 128, 200])
def test_sgd_promoted_kernel_matches_plain(cuda_device, vals_dtype, width):
    """K18 against its stream-order plain version (run on CPU copies:
    the card's ``index_add_`` adds in no fixed order), bit-exact: Zipfian
    duplicates with a row hit 5,000 times, negative ids, the sentinel,
    ids past the slab, NaN and Inf, an empty stream, int32/int64 ids,
    and update rows at an odd offset in memory."""
    from distributed_embeddings_torch.ops import (
        sgd_scatter_promoted, sgd_scatter_promoted_plain)

    rng = np.random.default_rng(width)
    R = 500
    for ids_dtype in (torch.int32, torch.int64):
        for n, hot in ((0, 0), (700, 0), (9000, 5000)):
            ids = (rng.zipf(1.2, size=n) - 1) % R
            ids[rng.permutation(n)[:hot]] = 7
            ids = np.concatenate([ids, [-1, -R, R, R + 3, -R - 1, 10 ** 6]])
            slab = rng.normal(size=(R, width)).astype(np.float32)
            slab[ids[0] if n else 0, 0] = np.nan
            vals = rng.normal(scale=3.0, size=(len(ids), width)).astype(
                np.float32)
            vals[1, -1] = np.inf
            s = torch.from_numpy(slab).to(torch.bfloat16)
            v = torch.from_numpy(vals).to(vals_dtype)
            i = torch.from_numpy(ids).to(ids_dtype)
            lr = torch.tensor(0.0173)
            got = s.to(cuda_device)
            before = sgd_scatter_promoted.launches
            sgd_scatter_promoted(got, i.to(cuda_device), v.to(cuda_device),
                                 lr.to(cuda_device))
            torch.cuda.synchronize()
            assert sgd_scatter_promoted.launches == before + 1
            want = sgd_scatter_promoted_plain(s.clone(), i, v, lr)
            _bf16_bits_equal(got, want, f"w{width} n{n} {ids_dtype}")
            if width % 4 == 0 and n:
                # update rows at an odd offset (a view into a larger buffer)
                flat = torch.empty(v.numel() + 1, dtype=v.dtype,
                                   device=cuda_device)
                vm = flat[1:].view(v.shape)
                vm.copy_(v.to(cuda_device))
                got = s.to(cuda_device)
                sgd_scatter_promoted(got, i.to(cuda_device), vm,
                                     lr.to(cuda_device))
                _bf16_bits_equal(got, want, f"w{width} n{n} misaligned")


@pytest.mark.cuda
@pytest.mark.parametrize("lr", [0.37, "tensor"])
@pytest.mark.parametrize("vals_dtype", [torch.float32, torch.bfloat16])
def test_sgd_dedup_chain_kernel_matches_plain(cuda_device, lr, vals_dtype):
    """K3's ``cast_vals=False`` chain (SparseSGD's DETPU_SGD_DEDUP
    branch) into a bf16 slab on unique rows: bit-exact."""
    rng = np.random.default_rng(3)
    R, w = 400, 128
    ids = np.concatenate([rng.permutation(R)[:300], [R]]).astype(np.int32)
    slab = torch.from_numpy(rng.normal(size=(R, w)).astype(np.float32)
                            ).to(torch.bfloat16)
    vals = torch.from_numpy(rng.normal(size=(len(ids), w)).astype(
        np.float32)).to(vals_dtype)
    t_lr = torch.tensor(0.0123) if lr == "tensor" else lr
    got = slab.to(cuda_device)
    sgd_scatter(got, torch.from_numpy(ids).to(cuda_device),
                vals.to(cuda_device),
                t_lr.to(cuda_device) if lr == "tensor" else t_lr,
                cast_vals=False)
    want = sgd_scatter_plain(slab.clone(), torch.from_numpy(ids), vals, t_lr,
                             cast_vals=False)
    _bf16_bits_equal(got, want, f"dedup chain lr={lr}")


def _float_bits_equal(got: torch.Tensor, want: torch.Tensor, what: str):
    """Bitwise float32/bfloat16 equality of a card tensor and a CPU one,
    a NaN matching any NaN."""
    if got.dtype == torch.bfloat16:
        return _bf16_bits_equal(got, want, what)
    g = got.detach().cpu().view(torch.int32).numpy().view(np.uint32)
    w = want.detach().cpu().view(torch.int32).numpy().view(np.uint32)
    gnan, wnan = (g & 0x7FFFFFFF) > 0x7F800000, (w & 0x7FFFFFFF) > 0x7F800000
    np.testing.assert_array_equal(gnan, wnan, err_msg=what)
    bad = (g != w) & ~gnan
    assert not bad.any(), f"{what}: {int(bad.sum())} elements differ"


def _capped_zipf(rng, n, rows, cap):
    """A Zipfian stream into ``rows`` rows in which no row has more than
    ``cap`` hits (an extra hit of a full row moves to the next row that
    is not full; n <= rows * cap)."""
    assert n <= rows * cap
    ids = (rng.zipf(1.2, size=n) - 1) % rows
    seen = np.zeros(rows, np.int64)
    for j, r in enumerate(ids):
        while seen[r] >= cap:
            r = (r + 1) % rows
        seen[r] += 1
        ids[j] = r
    return ids


@pytest.mark.cuda
@pytest.mark.parametrize("slab_dtype,vals_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("width", [3, 8, 16, 24, 128])
def test_sgd_scatter_bit_exact_up_to_the_split(cuda_device, slab_dtype,
                                               vals_dtype, width):
    """The sorted-segment K3 against its plain version run on CPU copies
    (``index_add_`` in stream order), BIT-EXACT when no row has more than
    ``SPLIT`` hits: Zipfian duplicates capped at ``SPLIT`` (a row at
    exactly ``SPLIT``), negative ids, the sentinel, ids past the slab,
    a NaN and an Inf in hit rows, int32 and int64 ids, a constant and a
    tensor lr, both chains (``cast_vals``), and update rows at an odd
    offset in memory (the one-column-a-lane path)."""
    from distributed_embeddings_torch.ops.scatter_add import SPLIT

    rng = np.random.default_rng(1000 + width)
    R = 700
    ids = _capped_zipf(rng, 6000, R, SPLIT - 1)  # -1 and -R add one hit
    ids[rng.permutation(6000)[:SPLIT - int((ids == 5).sum())]] = 5
    ids = np.concatenate([ids, [-1, -R, R, R + 3, -R - 1, 10 ** 6]])
    kept = ids[(ids >= -R) & (ids < R)]
    counts = np.bincount(np.where(kept < 0, kept + R, kept), minlength=R)
    assert counts.max() <= SPLIT and counts.max() >= SPLIT - 5
    slab = rng.normal(size=(R, width)).astype(np.float32)
    slab[ids[0], 0] = np.nan
    vals = rng.normal(scale=2.0, size=(len(ids), width)).astype(np.float32)
    vals[1, -1] = np.inf
    s = torch.from_numpy(slab).to(slab_dtype)
    v = torch.from_numpy(vals).to(vals_dtype)
    for ids_dtype in (torch.int32, torch.int64):
        i = torch.from_numpy(ids).to(ids_dtype)
        for lr in (0.37, torch.tensor(0.0123)):
            for cast in (True, False):
                if (cast and isinstance(lr, torch.Tensor)
                        and slab_dtype == torch.bfloat16):
                    continue  # the promoted chain: K18's test
                got = s.to(cuda_device)
                before = sgd_scatter.launches
                sgd_scatter(got, i.to(cuda_device), v.to(cuda_device),
                            lr.to(cuda_device) if isinstance(
                                lr, torch.Tensor) else lr, cast_vals=cast)
                torch.cuda.synchronize()
                assert sgd_scatter.launches == before + 1
                want = sgd_scatter_plain(s.clone(), i, v, lr, cast_vals=cast)
                what = f"w{width} {ids_dtype} lr={lr} cast={cast}"
                _float_bits_equal(got, want, what)
        # update rows at an odd offset: one column a lane
        flat = torch.empty(v.numel() + 1, dtype=v.dtype, device=cuda_device)
        vm = flat[1:].view(v.shape)
        vm.copy_(v.to(cuda_device))
        got = s.to(cuda_device)
        sgd_scatter(got, i.to(cuda_device), vm, 0.37)
        _float_bits_equal(got, sgd_scatter_plain(s.clone(), i, v, 0.37),
                          f"w{width} {ids_dtype} misaligned")


@pytest.mark.cuda
@pytest.mark.parametrize("slab_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [8, 128, 3])
def test_sgd_scatter_hot_rows_deterministic(cuda_device, slab_dtype, width):
    """A Zipfian stream with rows far past ``SPLIT`` hits (one at 20,000):
    two launches give the same bits, and the slab is within k ulps of the
    plain version (CPU, stream order) on a row k ids hit (the chunks are
    summed in float32, then added in chunk order); rows with at most
    ``SPLIT`` hits stay bit-exact. A control that drops every other
    position of the stream must fail the k-ulp bound."""
    from distributed_embeddings_torch.ops.scatter_add import SPLIT

    rng = np.random.default_rng(7 + width)
    R, n = 2000, 60000
    ids = (rng.zipf(1.1, size=n) - 1) % R
    ids[rng.permutation(n)[:20000]] = 17
    slab = rng.normal(size=(R, width)).astype(np.float32)
    vals = rng.normal(size=(n, width)).astype(np.float32)
    s = torch.from_numpy(slab).to(slab_dtype)
    v = torch.from_numpy(vals).to(slab_dtype)
    i = torch.from_numpy(ids.astype(np.int32))
    lr = 0.05
    a, b = s.to(cuda_device), s.to(cuda_device)
    sgd_scatter(a, i.to(cuda_device), v.to(cuda_device), lr)
    sgd_scatter(b, i.to(cuda_device), v.to(cuda_device), lr)
    assert torch.equal(_bits(a), _bits(b)), "two launches differ"
    want = sgd_scatter_plain(s.clone(), i, v, lr)
    k = np.bincount(ids, minlength=R)[:, None]
    assert k.max() > 5 * SPLIT
    mag = np.abs(to_np(s)).astype(np.float64)
    np.add.at(mag, ids, np.abs(lr * to_np(v)))
    ulps = k * (1.0 if slab_dtype == torch.bfloat16 else 2.0 ** -16)
    assert_within_ulps(to_np(a), to_np(want), mag, ulps, "hot rows")
    few = (k <= SPLIT)[:, 0]
    _float_bits_equal(a[torch.from_numpy(few).to(cuda_device)],
                      want[torch.from_numpy(few)], "rows with <= L hits")
    # the control: half the stream is not the function
    c = s.to(cuda_device)
    sgd_scatter(c, i[::2].contiguous().to(cuda_device),
                v[::2].contiguous().to(cuda_device), lr)
    with pytest.raises(AssertionError):
        assert_within_ulps(to_np(c), to_np(want), mag, ulps, "control")


@pytest.mark.cuda
def test_segment_scatter_all_sentinel_and_empty_streams(cuda_device):
    """A NaN batch routes every id to the sentinel: K3 and K18 leave the
    slab bitwise unchanged (nothing is kept, nothing is written), as does
    an empty stream (no launch)."""
    from distributed_embeddings_torch.ops import sgd_scatter_promoted

    R, w = 1000, 128
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        slab = torch.randn((R, w), generator=gen, device=cuda_device).to(
            dtype)
        before = slab.clone()
        ids = torch.full((5000,), R, dtype=torch.int32, device=cuda_device)
        vals = torch.full((5000, w), float("nan"), device=cuda_device).to(
            dtype)
        sgd_scatter(slab, ids, vals, 0.1)
        if dtype == torch.bfloat16:
            sgd_scatter_promoted(slab, ids, vals,
                                 torch.tensor(0.1, device=cuda_device))
        n0 = (sgd_scatter.launches, sgd_scatter_promoted.launches)
        empty = torch.zeros((0,), dtype=torch.int64, device=cuda_device)
        sgd_scatter(slab, empty, vals[:0], 0.1)
        if dtype == torch.bfloat16:
            sgd_scatter_promoted(slab, empty, vals[:0],
                                 torch.tensor(0.1, device=cuda_device))
        torch.cuda.synchronize()
        assert (sgd_scatter.launches, sgd_scatter_promoted.launches) == n0
        assert torch.equal(_bits(slab), _bits(before))


@pytest.mark.cuda
@pytest.mark.parametrize("vals_dtype", [torch.float32, torch.bfloat16])
def test_sgd_promoted_bit_exact_at_a_33k_hit_row(cuda_device, vals_dtype):
    """K18 at the example's hot-row length: a row hit 33,334 times (the
    block path's shared-memory ring) and rows around the block path's
    threshold (``LONG_SEGMENT`` - 1 and ``LONG_SEGMENT`` hits), w128 and
    w200, bit-exact to the plain version run on CPU copies."""
    from distributed_embeddings_torch.ops import (
        sgd_scatter_promoted, sgd_scatter_promoted_plain)
    from distributed_embeddings_torch.ops.scatter_add import LONG_SEGMENT

    rng = np.random.default_rng(33)
    R, n = 5000, 120000
    for width in (128, 200):
        ids = (rng.zipf(1.2, size=n) - 1) % R
        ids[ids == 7] = 8
        ids[ids == 9] = 8
        ids[ids == 11] = 8
        perm = rng.permutation(n)
        ids[perm[:33334]] = 7
        ids[perm[33334:33334 + LONG_SEGMENT - 1]] = 9
        ids[perm[40000:40000 + LONG_SEGMENT]] = 11
        slab = rng.normal(size=(R, width)).astype(np.float32)
        vals = rng.normal(scale=3.0, size=(n, width)).astype(np.float32)
        s = torch.from_numpy(slab).to(torch.bfloat16)
        v = torch.from_numpy(vals).to(vals_dtype)
        i = torch.from_numpy(ids.astype(np.int64))
        lr = torch.tensor(0.0173)
        got = s.to(cuda_device)
        sgd_scatter_promoted(got, i.to(cuda_device), v.to(cuda_device),
                             lr.to(cuda_device))
        want = sgd_scatter_promoted_plain(s.clone(), i, v, lr)
        _bf16_bits_equal(got, want, f"w{width} hot 33,334")


@pytest.mark.cuda
def test_segment_scatter_replays_in_a_cuda_graph(cuda_device):
    """One K3 call (float32 slab, a tensor lr, rows past ``SPLIT`` hits)
    and one K18 call captured on their records' hit path in a
    ``torch.cuda.CUDAGraph``: three replays on new ids, rows and lr
    written in place equal three eager calls bit for bit. Nothing is
    reset between calls (the sort's tile ticket numbers them), and the
    capture fails if a call synchronizes or reads a count on the host."""
    from distributed_embeddings_torch.ops import sgd_scatter_promoted

    R, n, w = 3000, 50000, 128
    gen = torch.Generator(device=cuda_device).manual_seed(11)

    def inputs():
        ids = (torch.randint(0, R, (n,), generator=gen, device=cuda_device)
               // torch.randint(1, 60, (n,), generator=gen,
                                device=cuda_device)).to(torch.int32)
        vals = torch.randn((n, w), generator=gen, device=cuda_device)
        return ids, vals, vals.to(torch.bfloat16)

    s32 = torch.randn((R, w), generator=gen, device=cuda_device)
    s16 = s32.to(torch.bfloat16)
    e32, e16 = s32.clone(), s16.clone()
    ids, vals, vb = inputs()
    lr = torch.tensor(0.01, device=cuda_device)

    def call(a, b):
        sgd_scatter(a, ids, vals, lr)
        sgd_scatter_promoted(b, ids, vb, lr)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # builds the records off the capture
        call(s32, s16)
    torch.cuda.current_stream().wait_stream(side)
    call(e32, e16)
    graph = torch.cuda.CUDAGraph()
    n0 = (sgd_scatter.launches, sgd_scatter_promoted.launches)
    with torch.cuda.graph(graph):
        call(s32, s16)
    assert (sgd_scatter.launches - n0[0],
            sgd_scatter_promoted.launches - n0[1]) == (1, 1)
    for k in range(3):
        new = inputs()
        for t, x in zip((ids, vals, vb), new):
            t.copy_(x)
        lr.fill_(0.01 * (k + 2))
        graph.replay()
        call(e32, e16)
        torch.cuda.synchronize()
        assert torch.equal(_bits(s32), _bits(e32)), f"K3 replay {k}"
        assert torch.equal(_bits(s16), _bits(e16)), f"K18 replay {k}"


@pytest.mark.cuda
def test_dlrm_example_on_the_card(cuda_device, tmp_path):
    """The example for 3 steps on the card with bf16 tables (K18 once a
    step), and a save at step 2 + restore to step 3 bitwise equal to the
    uninterrupted run."""
    from distributed_embeddings_torch.examples import dlrm_main
    from distributed_embeddings_torch.ops import sgd_scatter_promoted

    args = ["--batch_size", "256", "--table_sizes", ",".join(["500"] * 10),
            "--embedding_dim", "16", "--bottom_mlp_dims", "32,16",
            "--top_mlp_dims", "32,1", "--num_numerical_features", "4",
            "--param_dtype", "bfloat16", "--eval_batches", "1",
            "--checkpoint_out", str(tmp_path / "emb")]
    before = sgd_scatter_promoted.launches
    ref = dlrm_main.main(args + ["--num_batches", "3"])
    assert sgd_scatter_promoted.launches == before + 3
    assert np.isfinite(ref.losses).all() and ref.auc is not None
    ck = str(tmp_path / "ck")
    first = dlrm_main.main(args + ["--num_batches", "2", "--save_state", ck])
    second = dlrm_main.main(args + ["--num_batches", "3",
                                    "--restore_state", ck])
    assert first.losses + second.losses == ref.losses
    for k, v in ref.state.emb_params.items():
        assert torch.equal(v, second.state.emb_params[k])
    for a, b in zip(ref.state.dense_params.parameters(),
                    second.state.dense_params.parameters()):
        assert torch.equal(a, b)


# ------------------------------------------- K19/K20: the exchange packing


def _pack_layer(world, ragged, seed):
    """A random 12-table layer (planner only at world 8) and its inputs:
    multi-hot combiner-less inputs (multi-slot instances) or ragged
    weighted ones, with column slices at world 8."""
    from distributed_embeddings_torch.ops.embedding_lookup import Ragged

    rng = np.random.default_rng(seed)
    configs = [{"input_dim": int(rng.integers(4, 100)),
                "output_dim": int(rng.integers(1, 9)),
                "combiner": (str(rng.choice(["sum", "mean"])) if ragged
                             else rng.choice([None, "sum", "mean"]))}
               for _ in range(12)]
    de = DistributedEmbedding(
        configs, world, column_slice_threshold=150 if world > 1 else None,
        strategy="comm_balanced")
    b = 6
    if ragged:
        inputs = []
        for c in configs:
            rows = [list(rng.integers(0, c["input_dim"],
                                      size=rng.integers(0, 4)))
                    for _ in range(b)]
            inputs.append(Ragged.from_lists(
                rows, capacity=16,
                weights=[list(rng.uniform(0.5, 2, len(r))) for r in rows]))
    else:
        inputs = [torch.from_numpy(rng.integers(
            0, c["input_dim"], size=(b, int(rng.integers(1, 5)) if (
                c["combiner"] or world == 1) else 1)).astype(np.int32))
            for c in configs]
    return de, inputs


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else
                  torch.int32 if t.element_size() == 4 else torch.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("world,ragged", [(1, False), (8, False), (1, True),
                                          (8, True)])
def test_exchange_ids_kernel_matches_plain(cuda_device, world, ragged,
                                           ids_dtype):
    """K19: the id blocks bit-exact to the plain copy and to the JAX
    package's concatenation of cells, on the card."""
    from distributed_embeddings_torch.ops import exchange_pack as xp
    from distributed_embeddings_torch.parallel import exchange

    de, inputs = _pack_layer(world, ragged, seed=world + 10 * ragged)
    if ids_dtype == torch.int64:
        inputs = [x.long() if isinstance(x, torch.Tensor) else type(x)(
            values=x.values.long(), row_splits=x.row_splits,
            weights=x.weights) for x in inputs]
    entries, encs, _, dt = de._normalize_inputs(inputs, cuda_device)
    assert dt == ids_dtype
    b = inputs[0].nrows if ragged else inputs[0].shape[0]
    plan = de._get_plan(encs, b)
    before = xp.pack_ids.launches
    got = exchange.build_send_blocks(de, plan, entries, dt, cuda_device)
    torch.cuda.synchronize()
    assert xp.pack_ids.launches == before + 1
    want = exchange.build_send_blocks_plain(de, plan, entries, dt,
                                            cuda_device)
    srcs = [t.contiguous() for e in entries
            for t in (e[1:] if isinstance(e, tuple) else (e,))]
    plain = xp.pack_ids_plain(exchange._ids_copy_plan(de, plan, entries),
                              srcs, torch.empty_like(got))
    assert torch.equal(got, want) and torch.equal(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("src_dt,dst_dt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("world", [1, 8])
def test_exchange_columns_kernel_matches_plain(cuda_device, world, src_dt,
                                               dst_dt):
    """K20: the cotangent pack, the lookup rows (with the cast) and the
    dp-side unpack bit-exact to their plain versions on the card (NaN
    and Inf bits included)."""
    from distributed_embeddings_torch.ops import exchange_pack as xp
    from distributed_embeddings_torch.parallel import exchange

    de, inputs = _pack_layer(world, False, seed=3 + world)
    _, encs, _, _ = de._normalize_inputs(inputs, cuda_device)
    b = inputs[0].shape[0]
    plan = de._get_plan(encs, b)
    _, widths = exchange.slice_map(de, plan)
    gen = torch.Generator(device=cuda_device).manual_seed(world)

    def rand(*shape, dtype):
        t = torch.randn(*shape, generator=gen, device=cuda_device)
        t.view(-1)[::17] = float("nan")
        t.view(-1)[5::31] = float("inf")
        return t.to(dtype)

    for r in range(world):
        de._rank = r
        reds = [rand(world * g.n, b, g.width, dtype=src_dt)
                for g in plan.groups]
        n0 = xp.pack_columns.launches
        got = exchange.pack_lookup_rows(de, plan, reds, dst_dt, cuda_device)
        torch.cuda.synchronize()
        assert xp.pack_columns.launches == n0 + 1
        want = torch.empty_like(got)
        xp.batched_copy_plain(exchange.lookup_copy_plan(de, plan),
                              [x.reshape(-1) for x in reds], [want])
        assert torch.equal(_bits(got), _bits(want)), f"lookup rows rank {r}"
    grads = [rand(b, w, dtype=src_dt) for w in widths]
    wide = rand(b, sum(widths) + 3, dtype=src_dt)  # column slices of it
    pos = np.concatenate([[1], 1 + np.cumsum(widths)])
    for gs in (grads, [wide[:, p:p + w] for p, w in zip(pos, widths)]):
        got = exchange.pack_grad_blocks(de, plan, gs, b, src_dt)
        want = exchange.pack_grad_blocks_plain(de, plan, gs, b, src_dt)
        assert torch.equal(_bits(got), _bits(want))
    got = exchange.pack_grad_blocks(de, plan, grads, b, src_dt)
    want = exchange.pack_grad_blocks_plain(de, plan, grads, b, src_dt)
    assert torch.equal(_bits(got), _bits(want))
    dp = rand(world, b, plan.s_max, dtype=dst_dt)
    outs = exchange.unpack_outputs(de, plan, dp)
    cplan, pieces = exchange._unpack_copy_plan(de, plan)
    buf = torch.empty(sum(b * w for _, w in pieces), dtype=dst_dt,
                      device=cuda_device)
    xp.batched_copy_plain(cplan, [dp], [buf])
    for o, (off, w) in zip(outs, pieces):
        assert torch.equal(_bits(o), _bits(buf[off:off + b * w].view(b, w)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exchange_copy_kernel_unaligned_and_split(cuda_device, dtype):
    """Odd offsets and strides fall back to narrow units; more copies
    than one launch's parameter block holds take several launches; a
    zero-filled copy writes zeros; all bit-exact to the plain copy."""
    from distributed_embeddings_torch.ops import exchange_pack as xp

    rng = np.random.default_rng(0)
    copies = []
    for k in range(1300):
        rows, cols = int(rng.integers(1, 5)), int(rng.integers(1, 20))
        copies.append((-1 if k % 11 == 0 else 0, int(rng.integers(0, 50)),
                       cols + int(rng.integers(0, 3)), 0, k * 100 + (k % 3),
                       cols + (k % 2), rows, cols))
    plan = xp.CopyPlan(copies)
    src = torch.randn(400, device=cuda_device).to(dtype)
    got = torch.full((1300 * 100 + 200,), 7.0, device=cuda_device,
                     dtype=dtype)
    want = got.clone()
    n0 = xp.pack_columns.launches
    xp.pack_columns(plan, [src], [got])
    torch.cuda.synchronize()
    assert xp.pack_columns.launches == n0 + -(-1300 // xp.MAX_DESCS)
    xp.batched_copy_plain(plan, [src], [want])
    assert torch.equal(_bits(got), _bits(want))


# ---------------------------------------------------------------- K21, K22


def _health_tensors(dev, case):
    """Gradient lists for K21: the DLRM step's shapes (26 bf16 [65536,
    128] cotangents as column slices of one [65536, 27, 128] block, and
    the MLP's float32 gradients), or edge cases (empty, one element, odd
    sizes around the chunk and the 16-byte group, unaligned starts,
    strided views, NaN, Inf and finite values whose squares overflow)."""
    gen = torch.Generator(device=dev).manual_seed(21)
    if case == "dlrm":
        block = torch.randn((65536, 27, 128), generator=gen, device=dev
                            ).to(torch.bfloat16) * 1e-3
        outs = [block[:, i + 1] for i in range(26)]
        dense = [torch.randn(shape, generator=gen, device=dev) * 1e-2
                 for shape in ((512, 13), (512,), (256, 512), (256,),
                               (128, 256), (128,), (1024, 479), (1024,),
                               (1024, 1024), (1024,), (512, 1024), (512,),
                               (256, 512), (256,), (1, 256), (1,))]
        return outs + dense
    out = []
    for dt in (torch.float32, torch.bfloat16):
        for n in (0, 1, 7, 8, 9, 16383, 16384, 16385, 100_003):
            out.append(torch.randn(n, generator=gen, device=dev).to(dt))
        base = torch.randn(40_001, generator=gen, device=dev).to(dt)
        out.append(base[1:])                    # unaligned start
        wide = torch.randn((301, 50), generator=gen, device=dev).to(dt)
        out.append(wide[:, 3:27])               # strided, odd row stride
        out.append(wide[:, 8:40])               # strided, aligned columns
        nan = torch.randn(20_000, generator=gen, device=dev).to(dt)
        nan[12_345] = float("nan")
        out.append(nan)
        inf = torch.randn(20_000, generator=gen, device=dev).to(dt)
        inf[3] = float("-inf")
        inf[19_999] = float("inf")
        out.append(inf)
        big = torch.full((5,), 3e38, device=dev).to(dt)  # squares overflow
        out.append(big)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dlrm", "edges"])
def test_grad_health_kernel_matches_plain(cuda_device, case):
    """K21 against its plain version on the card: max |g| and the
    non-finite count exact (NaN equals NaN); the sum of squares within
    1.2e-5 relative (all terms are positive: each order's error is at
    most ~100 float32 roundings of the sum, 100 * 2^-24 = 6e-6 a side),
    infinite where the plain one is. Two runs give the same bits."""
    from distributed_embeddings_torch.ops import grad_health, grad_health_plain

    ts = _health_tensors(cuda_device, case)
    before = grad_health.launches
    got = grad_health(ts)
    again = grad_health(ts)
    assert grad_health.launches == before + 2
    want = grad_health_plain(ts)
    assert got.shape == (3, len(ts)) and got.device.type == "cuda"
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    g, w = to_np(got), to_np(want)
    np.testing.assert_array_equal(g[1:], w[1:])
    np.testing.assert_allclose(g[0], w[0], rtol=1.2e-5, atol=0)
    if case == "edges":
        assert np.isnan(g[1]).sum() == 2 and np.isinf(g[0]).sum() >= 4
        assert (g[2] > 0).sum() == 4


@pytest.mark.cuda
def test_grad_health_kernel_control_fails(cuda_device):
    """The control of the tolerance above: a sum missing one chunk's
    squares is far outside 1.2e-5."""
    from distributed_embeddings_torch.ops import grad_health, grad_health_plain

    t = torch.randn(100_000, device=cuda_device)
    got = to_np(grad_health([t[16384:]]))
    want = to_np(grad_health_plain([t]))
    assert abs(got[0, 0] - want[0, 0]) > 1.2e-5 * want[0, 0]


def _dense_case(dev, kind, seed):
    """Float32 parameters of odd sizes (one unaligned), their gradients
    and their optimizer state for K22."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = ((512, 13), (512,), (1,), (3, 5), (4099,), (1024, 479))
    params = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    shifted = torch.randn(1001, generator=gen, device=dev)[1:]
    params.append(shifted)                      # a 4-byte-aligned start
    grads = [torch.randn(p.shape, generator=gen, device=dev) * 0.1
             for p in params]
    n_state = {"sgd": 0, "momentum": 1, "nesterov": 1, "adagrad": 1,
               "adam": 2}[kind]
    state = [[torch.rand(p.shape, generator=gen, device=dev) * (j + 1) * 0.1
              for p in params] for j in range(n_state)]
    return params, grads, state


@pytest.mark.cuda
@pytest.mark.parametrize("ok", [None, True, False])
@pytest.mark.parametrize("kind,sched", [
    (k, s) for k in ("sgd", "momentum", "nesterov", "adam")
    for s in (False, True)] + [("adagrad", False)])
def test_dense_update_kernel_matches_plain(cuda_device, kind, sched, ok):
    """K22 against its plain version on the card, bit for bit: the
    parameters, every state tensor and the counts (with ``ok`` false all
    of them unchanged). Adagrad takes a constant lr, as its port does."""
    from distributed_embeddings_torch.ops import (bias_powers, dense_update,
                                                  dense_update_plain)

    runs = []
    for use_kernel in (True, False):
        params, grads, state = _dense_case(cuda_device, kind, 7)
        count = torch.tensor(41, dtype=torch.int32, device=cuda_device)
        scount = torch.tensor(9, dtype=torch.int32, device=cuda_device)
        okt = None if ok is None else torch.tensor(ok, device=cuda_device)
        nlr = (-(0.003 + 0.0001 * scount.float()) if sched else -0.0123)
        bp = bias_powers(count + 1, 0.9, 0.999) if kind == "adam" else None
        counts = ((count,) if kind == "adam" else ()) + (
            (scount,) if sched else ())
        hyper = {"momentum": 0.9, "eps": 1e-7 if kind == "adagrad" else 1e-8,
                 "b1": 0.9, "b2": 0.999, "eps_root": 0.0}
        s0 = state[0] if state else None
        s1 = state[1] if len(state) > 1 else None
        fn = dense_update if use_kernel else dense_update_plain
        before = dense_update.launches
        fn(kind, params, grads, s0, s1, nlr, hyper, bp=bp, ok=okt,
           counts=counts)
        assert dense_update.launches == before + use_kernel
        runs.append([*params, *(t for s in state for t in s), count,
                     scount])
    fresh = _dense_case(cuda_device, kind, 7)
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    if ok is False:
        for a, b in zip(runs[0], [*fresh[0], *(t for s in fresh[2]
                                               for t in s)]):
            assert torch.equal(a, b)
    else:
        assert not torch.equal(runs[0][0], fresh[0][0])


@pytest.mark.cuda
def test_instrumented_train_step_on_the_card_matches_the_cpu(cuda_device):
    """A small float32 DLRM, 5 instrumented steps (``with_metrics``, the
    guard on) with dense ``Adam`` on the card (K21, K22 and the DLRM
    kernels) and on the CPU (their plain versions) from one state, the
    third step a NaN batch: losses, tables, dense params and every
    metric within 1e-4 (integer metrics exact), the NaN step skipped on
    both."""
    from distributed_embeddings_torch.ops import dense_update, grad_health
    from distributed_embeddings_torch.utils import obs

    sizes = [500, 7, 33, 1200]
    cfg = DLRMConfig(table_sizes=sizes, embedding_dim=16,
                     num_numerical_features=13, bottom_mlp_dims=(32, 16),
                     top_mlp_dims=(64, 1))
    de = DistributedEmbedding(cfg.embedding_configs(), world_size=1)
    params = de.init(torch.Generator().manual_seed(0), device="cpu")
    dense = DLRMDense(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(1))

    def loss_fn(m, outs, batch):
        return bce_with_logits(m(batch[0], outs), batch[1])

    rng = np.random.default_rng(2)
    batches = [([_ids(rng, s, (256,)) for s in sizes],
                rng.normal(size=(256, 13)).astype(np.float32),
                (rng.random(256) < 0.3).astype(np.float32))
               for _ in range(5)]
    batches[2][1][7, 3] = np.nan
    out = {}
    for dev in ("cpu", cuda_device):
        d = DLRMDense(cfg, device=dev)
        d.load_state_dict(dense.state_dict())
        tx = Adam(0.01)
        state = HybridTrainState(
            emb_params={k: v.clone().to(dev) for k, v in params.items()},
            emb_opt_state=SparseSGD().init(params), dense_params=d,
            dense_opt_state=tx.init(list(d.parameters())),
            step=torch.zeros((), dtype=torch.int32, device=dev))
        step = make_hybrid_train_step(de, loss_fn, tx, SparseSGD(),
                                      lr_schedule=0.1, with_metrics=True,
                                      nan_guard=True)
        before = (grad_health.launches, dense_update.launches)
        losses, mets = [], []
        for cats, num, lab in batches:
            loss, state, m = step(state, [torch.from_numpy(c).to(dev)
                                          for c in cats],
                                  (torch.from_numpy(num).to(dev),
                                   torch.from_numpy(lab).to(dev)))
            losses.append(float(loss))
            mets.append({k: to_np(v) for k, v in m.items()})
        launched = (grad_health.launches - before[0],
                    dense_update.launches - before[1])
        assert launched == ((0, 0) if dev == "cpu" else (5, 5))
        assert set(obs.STEP_METRIC_KEYS) <= set(mets[0])
        out[str(dev)] = (losses, de.get_weights(state.emb_params),
                         [p.detach().cpu() for p in d.parameters()], mets,
                         int(state.dense_opt_state[0].count))
    (lc, tc, dc, mc, cc), (lg, tg, dg, mg, cg) = (out["cpu"],
                                                  out[str(cuda_device)])
    assert np.isnan(lc[2]) and np.isnan(lg[2]) and cc == cg == 4
    np.testing.assert_allclose(lg, lc, atol=1e-4, rtol=0)
    for a, b in zip(tg, tc):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    for a, b in zip(dg, dc):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=0)
    for k, (a, b) in enumerate(zip(mg, mc)):
        assert a["skipped_steps"][0] == b["skipped_steps"][0] == (k == 2)
        for key in a:
            if a[key].dtype.kind in "iu":
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            else:
                np.testing.assert_allclose(a[key], b[key], rtol=1e-4,
                                           atol=1e-6, err_msg=key)


# ------------------------------------- the launch records of K19/K20, K22


def _k22_step_args(dev, kind, sched, count, scount, okt):
    """One step's per-call arguments of K22 (new tensors each step, as
    the optimizers make them)."""
    from distributed_embeddings_torch.ops import bias_powers

    nlr = (-(0.003 + 0.0001 * scount.float()) if sched else -0.0123)
    bp = bias_powers(count + 1, 0.9, 0.999) if kind == "adam" else None
    counts = ((count,) if kind == "adam" else ()) + (
        (scount,) if sched else ())
    hyper = {"momentum": 0.9, "eps": 1e-7 if kind == "adagrad" else 1e-8,
             "b1": 0.9, "b2": 0.999, "eps_root": 0.0}
    return nlr, hyper, bp, okt, counts


@pytest.mark.cuda
@pytest.mark.parametrize("kind,sched", [
    ("sgd", False), ("sgd", True), ("momentum", True), ("nesterov", False),
    ("adagrad", False), ("adam", False), ("adam", True)])
def test_dense_update_records_hit_and_rebuild(cuda_device, kind, sched):
    """K22 through its launch record: three steps on one set of tensors
    (the first builds the record, the next two replay it), then the
    records dropped and three more (a forced rebuild), each step bit for
    bit equal to the plain version stepping a copy of the same state;
    the third step's verdict is false."""
    import importlib

    from distributed_embeddings_torch.ops import (dense_update,
                                                  dense_update_plain)
    mod = importlib.import_module("distributed_embeddings_torch.ops."
                                  "dense_update")

    sets = []
    for _ in range(2):
        params, grads, state = _dense_case(cuda_device, kind, 11)
        count = torch.tensor(41, dtype=torch.int32, device=cuda_device)
        scount = torch.tensor(9, dtype=torch.int32, device=cuda_device)
        sets.append((params, grads, state, count, scount))
    mod._CACHE.clear()
    builds = mod._CACHE.builds
    for k in range(6):
        if k == 3:
            mod._CACHE.clear()
        okt = torch.tensor(k != 2, device=cuda_device)
        for fn, (params, grads, state, count, scount) in zip(
                (dense_update, dense_update_plain), sets):
            nlr, hyper, bp, okt_, counts = _k22_step_args(
                cuda_device, kind, sched, count, scount, okt)
            fn(kind, params, grads, state[0] if state else None,
               state[1] if len(state) > 1 else None, nlr, hyper, bp=bp,
               ok=okt_, counts=counts)
        a, b = ([*p, *(t for s in st for t in s), c, sc]
                for p, _, st, c, sc in sets)
        for x, y in zip(a, b):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32)), k
    assert mod._CACHE.builds == builds + 2


@pytest.mark.cuda
@pytest.mark.parametrize("world", [1, 8])
def test_exchange_pack_records_hit_and_rebuild(cuda_device, world):
    """K19 and K20 through their launch records: the id blocks, the
    lookup rows and the cotangent pack three times each with the same
    tensors (one build, then replays), then after the plans' records are
    dropped (a rebuild), every result bit-exact to the plain copy."""
    from distributed_embeddings_torch.ops import exchange_pack as xp
    from distributed_embeddings_torch.parallel import exchange

    de, inputs = _pack_layer(world, False, seed=20 + world)
    de._rank = 0
    entries, encs, _, dt = de._normalize_inputs(inputs, cuda_device)
    b = inputs[0].shape[0]
    plan = de._get_plan(encs, b)
    ids_plan = exchange._ids_copy_plan(de, plan, entries)
    srcs = [t.contiguous() for e in entries
            for t in (e[1:] if isinstance(e, tuple) else (e,))]
    out = torch.empty((world, plan.l_max), dtype=dt, device=cuda_device)
    want_ids = xp.pack_ids_plain(ids_plan, srcs, torch.empty_like(out))
    _, widths = exchange.slice_map(de, plan)
    gen = torch.Generator(device=cuda_device).manual_seed(world)
    grads = [torch.randn(b, w, generator=gen, device=cuda_device
                         ).to(torch.bfloat16) for w in widths]
    gplan = exchange._grad_copy_plan(de, plan, b)
    packed = torch.empty((world, b, plan.s_max), dtype=torch.bfloat16,
                         device=cuda_device)
    want_g = xp.pack_columns_plain(gplan, grads, [torch.empty_like(packed)])
    lplan = exchange.lookup_copy_plan(de, plan)
    reds = [torch.randn(world * g.n * b * g.width, generator=gen,
                        device=cuda_device) for g in plan.groups]
    rows = torch.empty_like(packed)
    want_r = xp.pack_columns_plain(lplan, reds, [torch.empty_like(rows)])
    for cp in (ids_plan, gplan, lplan):
        cp.launch_cache.clear()
    want_n = tuple(-(-len(cp) // xp.MAX_DESCS) for cp in (ids_plan, gplan,
                                                          lplan))
    for k in range(6):
        if k == 3:
            for cp in (ids_plan, gplan, lplan):
                cp.launch_cache.clear()
        for t in (out, packed, rows):
            t.fill_(7)
        n0 = (xp.pack_ids.launches, xp.pack_columns.launches)
        xp.pack_ids(ids_plan, srcs, out)
        xp.pack_columns(gplan, grads, [packed])
        xp.pack_columns(lplan, reds, [rows])
        torch.cuda.synchronize()
        assert (xp.pack_ids.launches - n0[0],
                xp.pack_columns.launches - n0[1]) == (want_n[0],
                                                      want_n[1] + want_n[2])
        assert torch.equal(out, want_ids)
        assert torch.equal(_bits(packed), _bits(want_g[0]))
        assert torch.equal(_bits(rows), _bits(want_r[0]))
    assert [cp.launch_cache.builds for cp in (ids_plan, gplan, lplan)] == [
        2, 2, 2]


@pytest.mark.cuda
def test_launch_records_hit_path_still_raises(cuda_device):
    """With records in place, a call whose tensors differ in shape, dtype
    or device misses them and raises as the wrappers always have."""
    from distributed_embeddings_torch.ops import dense_update
    from distributed_embeddings_torch.ops import exchange_pack as xp

    params, grads, state = _dense_case(cuda_device, "momentum", 3)
    args = (None, -0.01, {"momentum": 0.9})
    dense_update("momentum", params, grads, state[0], *args)
    dense_update("momentum", params, grads, state[0], *args)
    bad = {"shape": [grads[0].reshape(-1)] + grads[1:],
           "dtype": [grads[0].double()] + grads[1:],
           "device": [grads[0].cpu()] + grads[1:]}
    for what, g in bad.items():
        with pytest.raises(ValueError):
            dense_update("momentum", params, g, state[0], *args)
    with pytest.raises(ValueError):
        dense_update("momentum", params, grads,
                     [state[0][0].cpu()] + state[0][1:], *args)
    plan = xp.CopyPlan([(0, 0, 4, 0, 0, 4, 3, 4), (1, 2, 4, 0, 12, 4, 1, 2)])
    srcs = [torch.arange(12, dtype=torch.int32, device=cuda_device),
            torch.arange(6, dtype=torch.int32, device=cuda_device)]
    out = torch.empty(16, dtype=torch.int32, device=cuda_device)
    xp.pack_ids(plan, srcs, out)
    xp.pack_ids(plan, srcs, out)
    assert plan.launch_cache.builds == 1
    for bad_srcs, bad_out in (([srcs[0][:8], srcs[1]], out),
                              ([srcs[0].long(), srcs[1]], out),
                              ([srcs[0].cpu(), srcs[1]], out),
                              (srcs, out[:8]), (srcs, out.float())):
        with pytest.raises(ValueError):
            xp.pack_ids(plan, bad_srcs, bad_out)
    _k1_k10_hits_still_raise(cuda_device)


def _k1_k10_calls(dev, seed=0):
    """Fixed inputs of K1 and the three K10 wrappers, and one call of
    each: ``(inputs, call)``, ``call()`` returning the four outputs."""
    from distributed_embeddings_torch.ops import (
        lengths_to_splits, ragged_row_ids, row_to_split)

    gen = torch.Generator(device=dev).manual_seed(seed)
    n, b, hot, rows = 3, 700, 2, 40
    x = dict(
        slab=torch.randn(n * rows, 24, generator=gen, device=dev
                         ).to(torch.bfloat16),
        ids=torch.randint(-2, rows + 2, (n, b, hot), generator=gen,
                          device=dev, dtype=torch.int32),
        rows=torch.full((n,), rows, dtype=torch.int64, device=dev),
        roff=torch.arange(n, dtype=torch.int64, device=dev) * rows,
        div=torch.tensor([1.0, 2.0, 1.0], device=dev),
        mask=torch.tensor([0, 1, 1], dtype=torch.int32, device=dev),
        weights=torch.rand(n, b, hot, generator=gen, device=dev),
        lengths=torch.randint(0, 9, (n, 9000), generator=gen, device=dev,
                              dtype=torch.int32),
        valid=torch.tensor([1, 0, 1], dtype=torch.int32, device=dev),
        coo=torch.sort(torch.randint(-3, 5003, (20000,), generator=gen,
                                     device=dev)).values,
        splits=torch.sort(torch.randint(0, 30000, (n, 801), generator=gen,
                                        device=dev), dim=1).values)

    def call():
        return (gather_combine(x["slab"], x["ids"], x["rows"], x["roff"],
                               x["div"], x["mask"], x["weights"]),
                lengths_to_splits(x["lengths"], x["valid"]),
                row_to_split(x["coo"], 5000, dtype=torch.int32),
                ragged_row_ids(x["splits"], 20000))

    return x, call


def _k1_k10_hits_still_raise(dev):
    from distributed_embeddings_torch.ops import (
        lengths_to_splits, ragged_row_ids, row_to_split)
    import importlib

    el = importlib.import_module(
        "distributed_embeddings_torch.ops.embedding_lookup")
    x, call = _k1_k10_calls(dev)
    call()
    caches = (el._GATHER, el._SPLITS, el._ROW_SPLITS, el._ROW_IDS)
    builds = [c.builds for c in caches]
    call()
    assert [c.builds for c in caches] == builds
    meta = (x["rows"], x["roff"], x["div"])
    for bad in (x["ids"][0], x["ids"].float(), x["ids"].cpu(),
                x["ids"].transpose(1, 2)):
        with pytest.raises(ValueError):
            gather_combine(x["slab"], bad, *meta)
    with pytest.raises(ValueError):
        gather_combine(x["slab"], x["ids"], x["rows"].cpu(), *meta[1:])
    with pytest.raises(ValueError):
        gather_combine(x["slab"], x["ids"], *meta, weights=x["weights"][:1])
    with pytest.raises(ValueError):
        gather_combine(x["slab"].half(), x["ids"], *meta)
    for lengths, valid in ((x["lengths"].float(), None),
                           (x["lengths"][:, ::2], None),
                           (x["lengths"], x["valid"].cpu()),
                           (x["lengths"], x["valid"][:2])):
        with pytest.raises(ValueError):
            lengths_to_splits(lengths, valid)
    for idx, kw in ((x["coo"].float(), {}),
                    (torch.stack([x["coo"]] * 3, 1), {}),
                    (torch.stack([x["coo"]] * 2, 0).t(), {}),
                    (x["coo"], {"dtype": torch.float32})):
        with pytest.raises(ValueError):
            row_to_split(idx, 5000, **kw)
    for sp in (x["splits"].float(), x["splits"].t()):
        with pytest.raises(ValueError):
            ragged_row_ids(sp, 20000)


@pytest.mark.cuda
def test_launch_records_replay_in_a_cuda_graph(cuda_device):
    """K22 (Adam with a schedule's -lr on the card, and SGD), K19/K20,
    K1 and the three K10 wrappers captured on their record's hit path in
    a ``torch.cuda.CUDAGraph``: three replays equal three eager steps bit
    for bit (K1/K10 on new inputs written in place before each). The
    capture fails if a hit synchronizes or copies from pageable
    memory."""
    from distributed_embeddings_torch.ops import (
        dense_update, lengths_to_splits, ragged_row_ids, row_to_split)
    from distributed_embeddings_torch.ops import exchange_pack as xp

    def k22_sets():
        out = []
        for kind in ("adam", "sgd"):
            params, grads, state = _dense_case(cuda_device, kind, 5)
            out.append((kind, params, grads, state,
                        torch.tensor(3, dtype=torch.int32,
                                     device=cuda_device),
                        torch.tensor(2, dtype=torch.int32,
                                     device=cuda_device)))
        return out

    okt = torch.ones((), dtype=torch.bool, device=cuda_device)

    def k22_step(sets):
        for kind, params, grads, state, count, scount in sets:
            nlr, hyper, bp, o, counts = _k22_step_args(
                cuda_device, kind, kind == "adam", count, scount, okt)
            dense_update(kind, params, grads, state[0] if state else None,
                         state[1] if len(state) > 1 else None, nlr, hyper,
                         bp=bp, ok=o, counts=counts)

    # 40 strided copies of narrowing rows (units of 2 to 16 bytes) into
    # disjoint regions, and a zero fill
    plan = xp.CopyPlan([(k % 3, 5 * k, 64, 0, 300 * k, 70, 4, 64 - k)
                        for k in range(40)] + [(-1, 0, 0, 0, 12000, 8, 1, 8)])
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    ids = [torch.randint(0, 1 << 30, (4 * 64 + 5 * 40,), generator=gen,
                         device=cuda_device, dtype=torch.int32)
           for _ in range(3)]
    flo = [torch.randn(4 * 64 + 5 * 40, generator=gen, device=cuda_device)
           for _ in range(3)]

    def pack_step(outs):
        xp.pack_ids(plan, ids, outs[0])
        xp.pack_columns(plan, flo, [outs[1]])

    eager, graphed = k22_sets(), k22_sets()
    outs_e = [torch.zeros(12008, dtype=torch.int32, device=cuda_device),
              torch.zeros(12008, dtype=torch.bfloat16, device=cuda_device)]
    outs_g = [torch.zeros_like(t) for t in outs_e]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    x, k1_k10 = _k1_k10_calls(cuda_device, seed=5)
    wrappers = (gather_combine, lengths_to_splits, row_to_split,
                ragged_row_ids)
    with torch.cuda.stream(side):  # builds the records off the capture
        k22_step(graphed)
        pack_step(outs_g)
        k1_k10()
    torch.cuda.current_stream().wait_stream(side)
    k22_step(eager)
    pack_step(outs_e)
    graph = torch.cuda.CUDAGraph()
    n0 = (dense_update.launches, xp.pack_ids.launches,
          *(f.launches for f in wrappers))
    with torch.cuda.graph(graph):
        k22_step(graphed)
        pack_step(outs_g)
        got = k1_k10()
    assert (dense_update.launches - n0[0], xp.pack_ids.launches - n0[1],
            *(f.launches - k for f, k in zip(wrappers, n0[2:]))
            ) == (2, 1, 1, 1, 1, 1)
    for k in range(3):
        # new inputs in place: the graph reads them where it was captured
        gen = torch.Generator(device=cuda_device).manual_seed(100 + k)
        for name in ("ids", "lengths", "coo", "splits"):
            t = x[name]
            t.copy_(torch.randint(-2, 42, t.shape, generator=gen,
                                  device=cuda_device).to(t.dtype))
        x["coo"].copy_(torch.sort(x["coo"] * 120).values)
        x["splits"].copy_(torch.sort(x["splits"].abs() * 700, dim=1).values)
        graph.replay()
        k22_step(eager)
        pack_step(outs_e)
        for a, b in zip(k1_k10(), got):
            assert torch.equal(_bits(a), _bits(b))
    torch.cuda.synchronize()
    for (_, pe, _, se, ce, sce), (_, pg, _, sg, cg, scg) in zip(eager,
                                                                 graphed):
        for a, b in zip([*pe, *(t for s in se for t in s), ce, sce],
                        [*pg, *(t for s in sg for t in s), cg, scg]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for a, b in zip(outs_e, outs_g):
        assert torch.equal(_bits(a), _bits(b))
    assert int(eager[0][4]) == 3 + 4


def _step_features(dev, shape, dtype, layout, seed):
    """The features as the DLRM step hands them to K2: the bottom-MLP
    output and F - 1 pieces of one embedding buffer (``"step"``), or
    column slices of one ``[B, (F - 1) D]`` tensor (``"columns"``); and
    their stack."""
    b, f, d = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g).to(dtype).to(dev)
    bottom = x[:, 0].contiguous()
    if layout == "step":
        buf = torch.empty(((f - 1) * b, d), dtype=dtype, device=dev)
        embs = [buf[k * b:(k + 1) * b] for k in range(f - 1)]
    else:
        wide = torch.empty((b, (f - 1) * d), dtype=dtype, device=dev)
        embs = [wide[:, k * d:(k + 1) * d] for k in range(f - 1)]
    for k, e in enumerate(embs):
        e.copy_(x[:, k + 1])
    return [bottom] + embs, x


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["step", "columns"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 27, 128), (257, 27, 128),
                                   (33, 27, 16), (9, 5, 13),
                                   (65536, 27, 128)])
def test_dot_interact_list_kernels_match_plain(cuda_device, dtype, shape,
                                               layout):
    """K2 and K4 on the features where the step leaves them (no stack):
    the tensor-core kernels for bf16 with D a multiple of 16, the
    CUDA-core ones otherwise; against the plain versions with the
    stacked form's tolerances, and bit-identical to the stacked form."""
    from distributed_embeddings_torch.ops.interaction import \
        tensor_core_paths

    b, f, d = shape
    feats, x = _step_features(cuda_device, shape, dtype, layout, seed=11)
    dy = torch.randn((b, f * (f - 1) // 2 + d),
                     generator=torch.Generator().manual_seed(12)).to(
        dtype).to(cuda_device)
    tc = dtype == torch.bfloat16 and d % 16 == 0
    assert tensor_core_paths(feats) == (1 if tc else 0)
    assert tensor_core_paths(feats, dy) == (3 if tc else 0)
    n0 = (dot_interact_fwd.launches, dot_interact_bwd.launches)
    out = dot_interact_fwd(feats)
    grads = dot_interact_bwd(feats, dy)
    assert (dot_interact_fwd.launches - n0[0],
            dot_interact_bwd.launches - n0[1]) == (1, 1)
    assert len(grads) == f and all(g.is_contiguous() for g in grads)
    got, want = to_np(out), to_np(dot_interact_fwd_plain(x))
    np.testing.assert_array_equal(got[:, -d:], want[:, -d:])
    _k2_close(got, want, dtype, "dot_interact list")
    gb = np.stack([to_np(g) for g in grads], 1)
    wb = to_np(dot_interact_bwd_plain(x, dy))
    scale = to_np(dot_interact_bwd_plain(x.float().abs(), dy.float().abs()))
    if dtype == torch.float32:
        np.testing.assert_array_less(np.abs(gb - wb), 1e-5 * scale + 1e-30)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(wb),
                                                  2.0 ** -126))) - 7)
        np.testing.assert_array_less(np.abs(gb - wb),
                                     ulp + 2.0 ** -20 * scale + 1e-30)
    # the stacked form runs the same per-sample arithmetic
    assert torch.equal(_bits(out), _bits(dot_interact_fwd(x)))
    whole = dot_interact_bwd(x, dy)
    for k, g in enumerate(grads):
        assert torch.equal(_bits(g), _bits(whole[:, k]))


@pytest.mark.cuda
def test_dot_interact_refuses_layouts_it_does_not_take(cuda_device):
    """A transposed feature and a misaligned bf16 row on the tensor-core
    shapes raise on the card too; the wrapper copies nothing."""
    feats, _ = _step_features(cuda_device, (64, 5, 16), torch.bfloat16,
                              "step", seed=1)
    with pytest.raises(ValueError, match="feature 2.*not contiguous"):
        dot_interact_fwd(feats[:2] + [feats[2].t().contiguous().t()]
                         + feats[3:])
    wide = torch.zeros((64, 40), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="feature 1's rows are not 16-B"):
        dot_interact_fwd([feats[0], wide[:, 1:17]] + feats[2:])


@pytest.mark.cuda
def test_bf16_train_step_on_the_card_matches_the_cpu(cuda_device):
    """A small DLRM with bf16 compute at width 16 (K2 and K4 on the
    tensor cores, F = 5) trained 3 steps in lockstep: each step runs on
    the card from the CPU run's state, and the two results must agree
    within bf16's rounding of the MLP products (cuBLAS and the CPU round
    them at other places): losses within 1e-2, dense params and tables
    within 1e-3."""
    from distributed_embeddings_torch.ops.interaction import \
        tensor_core_paths

    sizes = [500, 7, 33, 1200]
    cfg = DLRMConfig(table_sizes=sizes, embedding_dim=16,
                     num_numerical_features=13, bottom_mlp_dims=(32, 16),
                     top_mlp_dims=(64, 1), compute_dtype=torch.bfloat16)
    de = DistributedEmbedding(cfg.embedding_configs(), world_size=1,
                              compute_dtype=torch.bfloat16)
    params = de.init(torch.Generator().manual_seed(0), device="cpu")
    dense = DLRMDense(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(1))

    def loss_fn(m, outs, batch):
        return bce_with_logits(m(batch[0], outs), batch[1])

    rng = np.random.default_rng(2)
    batches = [([_ids(rng, s, (256,)) for s in sizes],
                rng.normal(size=(256, 13)).astype(np.float32),
                (rng.random(256) < 0.3).astype(np.float32))
               for _ in range(3)]

    def state_on(dev, emb, dparams):
        d = DLRMDense(cfg, device=dev)
        d.load_state_dict(dparams)
        return HybridTrainState(
            emb_params={k: v.clone().to(dev) for k, v in emb.items()},
            emb_opt_state=SparseSGD().init(emb), dense_params=d,
            dense_opt_state=(),
            step=torch.zeros((), dtype=torch.int32, device=dev))

    step = make_hybrid_train_step(de, loss_fn, SGD(0.1), SparseSGD(),
                                  lr_schedule=0.1)
    emb, dparams = params, dense.state_dict()
    n0 = (dot_interact_fwd.launches, dot_interact_bwd.launches)
    for cats, num, lab in batches:
        out = {}
        for dev in ("cpu", cuda_device):
            st = state_on(dev, emb, dparams)
            loss, st = step(st, [torch.from_numpy(c).to(dev) for c in cats],
                            (torch.from_numpy(num).to(dev),
                             torch.from_numpy(lab).to(dev)))
            out[str(dev)] = (float(loss), {k: v.cpu() for k, v in
                                           st.emb_params.items()},
                             {k: v.cpu() for k, v in
                              st.dense_params.state_dict().items()})
        (lc, ec, dc), (lg, eg, dg) = out["cpu"], out[str(cuda_device)]
        assert abs(lc - lg) <= 1e-2, (lc, lg)
        for k in dc:
            np.testing.assert_allclose(dg[k].numpy(), dc[k].numpy(),
                                       atol=1e-3, rtol=0)
        for k in ec:
            np.testing.assert_allclose(eg[k].float().numpy(),
                                       ec[k].float().numpy(), atol=1e-3,
                                       rtol=0)
        emb, dparams = ec, dc
    assert (dot_interact_fwd.launches - n0[0],
            dot_interact_bwd.launches - n0[1]) == (3, 3)
    feats, _ = _step_features(cuda_device, (256, 5, 16), torch.bfloat16,
                              "step", seed=3)
    assert tensor_core_paths(feats) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dot_interact_records_replay_in_a_cuda_graph(cuda_device, dtype):
    """A K2 + K4 pair on the step's features, captured on the records'
    hit path in a ``torch.cuda.CUDAGraph``: three replays on new inputs
    written in place equal eager calls bit for bit (the tensor-core
    kernels for bf16, the CUDA-core ones for float32). The capture fails
    if a hit synchronizes or copies from pageable memory."""
    shape = (1000, 27, 128)
    feats, _ = _step_features(cuda_device, shape, dtype, "step", seed=21)
    dy = torch.randn((1000, 351 + 128), device=cuda_device).to(dtype)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # builds the records off the capture
        dot_interact_fwd(feats)
        dot_interact_bwd(feats, dy)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n0 = (dot_interact_fwd.launches, dot_interact_bwd.launches)
    with torch.cuda.graph(graph):
        out = dot_interact_fwd(feats)
        grads = dot_interact_bwd(feats, dy)
    assert (dot_interact_fwd.launches - n0[0],
            dot_interact_bwd.launches - n0[1]) == (1, 1)
    for k in range(3):
        gen = torch.Generator(device=cuda_device).manual_seed(300 + k)
        for t in feats + [dy]:
            t.copy_(torch.randn(t.shape, generator=gen, device=cuda_device))
        graph.replay()
        want = dot_interact_fwd(feats)
        wgrads = dot_interact_bwd(feats, dy)
        assert torch.equal(_bits(out), _bits(want))
        for a, b in zip(grads, wgrads):
            assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
def test_dot_interact_records_follow_moved_features(cuda_device):
    """Features at new addresses (the allocator moved them) build a record
    of their own and give the stacked form's bits; the earlier features
    still find theirs; a feature moved off a 16-B boundary is refused."""
    from distributed_embeddings_torch.ops import interaction as it

    shape = (300, 27, 128)
    a, _ = _step_features(cuda_device, shape, torch.bfloat16, "step", 31)
    b, xb = _step_features(cuda_device, shape, torch.bfloat16, "step", 32)
    dy = torch.randn((300, 351 + 128), device=cuda_device).to(torch.bfloat16)
    it.dot_interact_fwd(a)
    it.dot_interact_bwd(a, dy)
    built = (it._FWD.builds, it._BWD.builds)
    out = it.dot_interact_fwd(b)
    grads = it.dot_interact_bwd(b, dy)
    assert (it._FWD.builds, it._BWD.builds) == (built[0] + 1, built[1] + 1)
    it.dot_interact_fwd(a)
    it.dot_interact_bwd(a, dy)
    assert (it._FWD.builds, it._BWD.builds) == (built[0] + 1, built[1] + 1)
    assert torch.equal(_bits(out), _bits(dot_interact_fwd(xb)))
    whole = dot_interact_bwd(xb, dy)
    for k, g in enumerate(grads):
        assert torch.equal(_bits(g), _bits(whole[:, k]))
    wide = torch.empty(300 * 128 + 8, dtype=torch.bfloat16,
                       device=cuda_device)
    mis = wide[1:1 + 300 * 128].view(300, 128)
    with pytest.raises(ValueError, match="feature 3's rows are not 16-B"):
        it.dot_interact_fwd(b[:3] + [mis] + b[4:])
    with pytest.raises(ValueError, match="feature 3's rows are not 16-B"):
        it.dot_interact_bwd(b[:3] + [mis] + b[4:], dy)


# ---------------------------------- K8 staged rows, K5 on the engine, C6


def _k8_stream(rng, rows, b, max_hot, bad, cap_frac, ids_dt, cap=None):
    """A ragged id block ``[n, 2 cap]`` (values, then float32 weight
    bits) over tables of ``rows`` rows: U{1..max_hot} ids a sample,
    Zipfian (alpha 1.05) ranks hashed to random rows (the hot rows are
    not the low ids), a ``bad`` share of negative and past-the-table
    ids; ``cap_frac`` below 1 truncates the last rows (``cap``, if given,
    is the capacity)."""
    n = len(rows)
    lengths = rng.integers(1, max_hot + 1, size=(n, b))
    splits = np.zeros((n, b + 1), np.int64)
    np.cumsum(lengths, axis=1, out=splits[:, 1:])
    if cap is None:
        cap = max(1, int(splits[:, -1].max() * cap_frac))
    vals = np.zeros((n, cap), np.int64)
    for k, r in enumerate(rows):
        rank = (rng.zipf(1.05, size=cap) - 1) % r
        vals[k] = rng.permutation(r)[rank]
        flip = rng.random(cap) < bad
        vals[k] = np.where(flip, rng.choice([-1, -7, r, r + 3], size=cap),
                           vals[k])
    w = rng.uniform(0.25, 2.0, size=(n, cap)).astype(np.float32)
    block = np.concatenate([vals, w.view(np.int32).astype(np.int64)], 1)
    return torch.from_numpy(block).to(ids_dt), cap, torch.from_numpy(splits)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("width", [3, 8, 16, 128])
def test_ragged_combine_zipf_streams_bit_exact(cuda_device, dtype,
                                               out_dtype, width):
    """K8 bit-exact to the plain version (a NaN equals a NaN): a Zipfian
    50,000-row table whose hot rows are hashed (not the low ids), a
    700-row table every tile hits whole, tables of 3, 4 and 10 rows; ~1%
    bad ids, the mask on and off, a NaN in the row a masked
    past-the-table id clips to (the NaN propagates); weights (in the id
    block), mean slots, capacity truncation; int32 and int64 ids as
    strided views."""
    from distributed_embeddings_torch.ops import (ragged_combine,
                                                  ragged_combine_plain)

    rng = np.random.default_rng(7 * width)
    rows = [50000, 700, 3, 4, 10]
    n, b = len(rows), 1100  # five tiles of 256 samples, the last short
    roff = np.concatenate([[0], np.cumsum(rows)[:-1]])
    host = rng.normal(size=(sum(rows), width)).astype(np.float32)
    host[roff[0] + rows[0] - 1] = np.nan  # the clip target of ids >= R
    slab = torch.from_numpy(host).to(dtype).to(cuda_device)
    meta = dict(rows=torch.tensor(rows, dtype=torch.int64,
                                  device=cuda_device),
                roff=torch.from_numpy(roff).to(cuda_device))
    for ids_dt, cap_frac in ((torch.int32, 1.0), (torch.int64, 0.8)):
        block, cap, splits = _k8_stream(rng, rows, b, 30, 0.01, cap_frac,
                                        ids_dt)
        block = block.to(cuda_device)
        values = block[:, :cap]
        for wts, mean, mask in ((None, None, None),
                                (block[:, cap:], (1, 0, 1, 0, 1),
                                 (1, 1, 0, 1, 0)),
                                (None, (0, 1, 0, 1, 0), (1, 0, 1, 0, 1))):
            kw = dict(meta, splits=splits.to(cuda_device), weights=wts,
                      mean=None if mean is None else torch.tensor(
                          mean, dtype=torch.int32, device=cuda_device),
                      mask=None if mask is None else torch.tensor(
                          mask, dtype=torch.int32, device=cuda_device),
                      out_dtype=out_dtype)
            got = ragged_combine(slab, values, **kw)
            want = ragged_combine_plain(slab, values, **kw)
            what = f"{ids_dt} cap {cap_frac} w={wts is not None} {mean}"
            assert got.dtype == out_dtype
            _float_bits_equal(got, want, what)
            # the NaN row read (masked or not: 0 * NaN is NaN) is kept
            assert torch.isnan(got[0].float()).any(), what
    torch.cuda.synchronize()


def _k8_counting_library():
    """A build of ``csrc/ragged_combine.cu`` that counts its general-form
    calls (``k8_variants.COUNT_GENERAL``), with that counter's reader."""
    import ctypes
    import importlib.util
    import pathlib
    import sys

    from distributed_embeddings_torch.ops import _kernels

    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        spec = importlib.util.spec_from_file_location(
            "k8_variants", root / "k8_variants.py")
        k8 = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(k8)
    finally:
        sys.path.remove(str(root))
    lib = k8.vs.build(_kernels, "ragged_combine",
                      {"count": k8.COUNT_GENERAL}, "tests")["count"]
    lib.detpu_k8_general_calls.argtypes = []
    lib.detpu_k8_general_calls.restype = ctypes.c_ulonglong
    return k8, lib


@pytest.mark.cuda
def test_ragged_combine_long_rows_take_the_flat_form(cuda_device):
    """Rows of U{1..hot} ids a sample, hot 60 to 2,000 (means 30 to
    1,000, past the 20 a sample the first sizing of the source words
    held), take the flat form, in passes of whole rows: a build that
    counts the kernel's general-form calls counts none. A row past the
    source words (70,000 ids) is the one general-form call of its
    launch. Every result bit-exact to the plain version (fp32, weights,
    a mean slot, ~1% bad ids masked)."""
    import importlib

    from distributed_embeddings_torch.ops import ragged_combine_plain

    el = importlib.import_module(
        "distributed_embeddings_torch.ops.embedding_lookup")
    k8, lib = _k8_counting_library()
    rng = np.random.default_rng(11)
    rows = [30000, 500]
    roff = torch.tensor([0, 30000], dtype=torch.int64, device=cuda_device)
    slab = torch.randn((30500, 16), device=cuda_device)
    meta = dict(rows=torch.tensor(rows, dtype=torch.int64,
                                  device=cuda_device), roff=roff,
                mean=torch.tensor([0, 1], dtype=torch.int32,
                                  device=cuda_device),
                mask=torch.ones(2, dtype=torch.int32, device=cuda_device))
    for hot, b, long_row in ((60, 1100, False), (400, 600, False),
                             (2000, 300, False), (20, 300, True)):
        block, cap, splits = _k8_stream(rng, rows, b, hot, 0.01, 1.0,
                                        torch.int32)
        if long_row:  # sample 100 of slot 0 gets 70,000 ids
            ln = np.diff(splits.numpy(), axis=1)
            ln[0, 100] = 70000
            sp = np.zeros_like(splits.numpy())
            np.cumsum(ln, axis=1, out=sp[:, 1:])
            cap = int(sp[:, -1].max())
            splits = torch.from_numpy(sp)
            block, _, _ = _k8_stream(rng, rows, b, hot, 0.01, 1.0,
                                     torch.int32, cap)
        block = block.to(cuda_device)
        kw = dict(meta, splits=splits.to(cuda_device),
                  weights=block[:, cap:])
        values = block[:, :cap]
        with k8.library(el, lib):
            rec = el.build_ragged_record(slab, values, **kw)
        got = torch.empty(*rec.payload[0], device=cuda_device)
        before = lib.detpu_k8_general_calls()
        rec.replay(values.data_ptr(), kw["splits"].data_ptr(),
                   kw["weights"].data_ptr(), got.data_ptr())
        torch.cuda.synchronize()
        general = lib.detpu_k8_general_calls() - before
        assert general == int(long_row), (hot, general)
        want = ragged_combine_plain(
            slab.cpu(), values.cpu(),
            **{k: v.cpu() for k, v in kw.items()})
        _float_bits_equal(got, want, f"hot {hot} long row {long_row}")


@pytest.mark.cuda
def test_ragged_combine_and_dedup_replay_in_a_cuda_graph(cuda_device):
    """K8 (fp32 slab, bf16 output, in-block weights, a mean slot) and K5
    (int32 ids with a valid mask, w16 float32 rows, a hot id past the
    engine's L) captured on their records' hit path in a
    ``torch.cuda.CUDAGraph``: three replays on new ids, splits and rows
    written in place equal three eager calls bit for bit. The capture
    fails if a call synchronizes or reads a count on the host."""
    from distributed_embeddings_torch.ops import ragged_combine

    rng = np.random.default_rng(3)
    rows = [20000, 600, 10]
    roff = torch.tensor([0, 20000, 20600], dtype=torch.int64,
                        device=cuda_device)
    slab = torch.randn((20610, 128), device=cuda_device)
    rtab = torch.tensor(rows, dtype=torch.int64, device=cuda_device)
    mean = torch.tensor([0, 1, 0], dtype=torch.int32, device=cuda_device)
    cap = 700 * 20  # every stream's capacity: the most ids it can hold
    block, _, splits = _k8_stream(rng, rows, 700, 20, 0.01, 1.0,
                                  torch.int32, cap)
    block, splits = block.to(cuda_device), splits.to(cuda_device)
    n, w = 60000, 16
    ids = torch.zeros(n, dtype=torch.int32, device=cuda_device)
    vals = torch.zeros((n, w), device=cuda_device)
    valid = torch.ones(n, dtype=torch.bool, device=cuda_device)

    def new_inputs():
        nb, _, ns = _k8_stream(rng, rows, 700, 20, 0.01, 1.0, torch.int32,
                               cap)
        block.copy_(nb)
        splits.copy_(ns)
        hot = np.concatenate([rng.integers(0, 5000, n - 1000),
                              np.full(1000, 77)])
        ids.copy_(torch.from_numpy(rng.permutation(hot)).int())
        vals.copy_(torch.randn((n, w), device=cuda_device))
        valid.copy_(torch.from_numpy(rng.random(n) < 0.9))

    def call():
        out = ragged_combine(slab, block[:, :cap], splits, rtab, roff,
                             mean=mean, weights=block[:, cap:],
                             out_dtype=torch.bfloat16)
        return (out, *dedup_sparse_grad(ids, vals, pad_id=5000,
                                        valid=valid, max_unique=4000))

    new_inputs()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # builds the records off the capture
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    n0 = (ragged_combine.launches, dedup_sparse_grad.launches)
    with torch.cuda.graph(graph):
        g_out = call()
    assert (ragged_combine.launches - n0[0],
            dedup_sparse_grad.launches - n0[1]) == (1, 1)
    for k in range(3):
        new_inputs()
        graph.replay()
        e_out = call()
        torch.cuda.synchronize()
        for name, g, e in zip(("K8", "K5 ids", "K5 rows"), g_out, e_out):
            assert torch.equal(_bits(g) if g.is_floating_point() else g,
                               _bits(e) if e.is_floating_point() else e), (
                f"{name} replay {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 256, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dot_interact_feature_counts_on_the_card(cuda_device, dtype, f):
    """Feature counts JAX takes and the first kernels refused (C6): with
    one feature the model's ``dot_interact`` hands the bottom output
    through and launches nothing; K2 and K4 still take it (a copy and the
    appended row's cotangent). 256 and 300 features (the stacked
    CUDA-core kernels past the table, their wide form where the shared
    memory or the pair codes end) run on the kernels, counted, held to
    the plain versions at the stacked form's tolerances."""
    from distributed_embeddings_torch.models import dot_interact

    b, d = 64, 16
    gen = torch.Generator().manual_seed(f)
    x = torch.randn((b, f, d), generator=gen).to(dtype).to(cuda_device)
    feats = list(x.unbind(1))
    dy = torch.randn((b, f * (f - 1) // 2 + d), generator=gen).to(
        dtype).to(cuda_device)
    n0 = (dot_interact_fwd.launches, dot_interact_bwd.launches)
    if f == 1:
        bottom = feats[0].clone().requires_grad_(True)
        out = dot_interact([], bottom)
        out.backward(dy)
        assert out is bottom and torch.equal(bottom.grad, dy)
        assert (dot_interact_fwd.launches, dot_interact_bwd.launches) == n0
    out = dot_interact_fwd(feats)
    grads = dot_interact_bwd(feats, dy)
    assert (dot_interact_fwd.launches - n0[0],
            dot_interact_bwd.launches - n0[1]) == (1, 1)
    got, want = to_np(out), to_np(dot_interact_fwd_plain(x))
    assert got.shape == (b, f * (f - 1) // 2 + d)
    np.testing.assert_array_equal(got[:, -d:], want[:, -d:])
    _k2_close(got, want, dtype, f"dot_interact F={f}")
    gb = np.stack([to_np(g) for g in grads], 1)
    wb = to_np(dot_interact_bwd_plain(x, dy))
    scale = to_np(dot_interact_bwd_plain(x.float().abs(), dy.float().abs()))
    if dtype == torch.float32:
        np.testing.assert_array_less(np.abs(gb - wb), 1e-5 * scale + 1e-30)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(wb),
                                                  2.0 ** -126))) - 7)
        np.testing.assert_array_less(np.abs(gb - wb),
                                     ulp + 2.0 ** -20 * scale + 1e-30)
