"""The port's kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: they skip without a card. On the GPU, where JAX is not
installed, run them without the suite's JAX conftest::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the hotness-1 gather and the bottom-row copy of the
interaction are bit-exact; fp32-accumulated sums (hotness 3, weights,
the pair dot products) are within 1 bf16 ulp of the plain result (bf16)
or 1e-6 / 1e-5 relative (fp32), since the kernel sums in another order.
The interaction backward (K4) is within 1 bf16 ulp of the plain result
plus 2^-20 of the sum of |terms| (fp32 order; fp32: 1e-5 of that sum).
The SGD scatter (K3) is bit-exact on rows one id updates and on dyadic
float32 duplicates; a row that k ids update with inexact sums is within
k ulps of its dtype of ``|old| + sum |update|`` (both sides add with
atomics, in an order of the card's choosing). A small DLRM trained 5
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
card equals its uninterrupted run bitwise.
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

from torch_parity import assert_within_ulps, cuda_device, to_np  # noqa: F401

torch.set_num_threads(1)


def _ids(rng, vocab, shape):
    """Ids mostly in range, with negatives and ids past the table."""
    return rng.integers(-3, vocab + 3, size=shape).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [3, 8, 16, 24, 128])
def test_gather_combine_kernel_matches_plain(cuda_device, dtype, width):
    rng = np.random.default_rng(width)
    n, b, hot, rows = 3, 70, 3, 50
    slab = torch.from_numpy(rng.normal(size=(n * rows, width))
                            .astype(np.float32)).to(dtype).to(cuda_device)
    for ids_dtype in (torch.int32, torch.int64):
        for hot_ in (1, hot):
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
                elif dtype == torch.float32:
                    np.testing.assert_allclose(got, want, rtol=1e-6,
                                               atol=1e-6)
                else:
                    assert_within_ulps(got, want,
                                       np.maximum(np.abs(want), 1e-30), 1,
                                       f"w{width} hot{hot_} {drop}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 27, 128), (257, 27, 128),
                                   (33, 27, 16), (9, 5, 13)])
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
                                   (33, 27, 16), (9, 5, 13)])
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
@pytest.mark.parametrize("width", [1, 8, 16, 40])
def test_dedup_kernel_matches_plain(cuda_device, dtype, width):
    """K5 against its plain version: unique ids bit-exact (tail
    included); a row that k ids sum is a fp32 sum taken in stable order
    in 256-row pieces by the kernel and with atomics by the plain
    version, each within (k - 1) 2^-24 of the sum of |rows|: float32
    sums within 2 k 2^-24 of it, bf16 sums within 1 bf16 ulp of the
    plain result more (both round one fp32 sum once). Two runs of the
    kernel agree bitwise."""
    rng = np.random.default_rng(width)
    for n, rows, hot_run, ids_dtype, kw in (
            (1, 10, 0, torch.int32, {}),
            (700, 50, 0, torch.int64, {}),
            (20000, 3000, 9000, torch.int32, {}),
            (5000, 10 ** 6, 2000, torch.int32, {}),
            (3000, 100, 0, torch.int32, {"max_unique": 40}),
            (3000, 100, 600, torch.int64, {"valid": True})):
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
      row equals the float32 sum in K5's fixed order (the stably sorted
      rows cut at multiples of 256, each piece summed in order, then the
      pieces in order), which numpy repeats;
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
    start = int((ids < hot).sum())  # the hot id's first sorted position
    cuts = np.r_[0, np.arange((start // chunk + 1) * chunk,
                              start + len(rows), chunk) - start, len(rows)]
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
    tids[:topk // 2] = rng.permutation(50)[:topk // 2]
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
])
def test_sketch_kernels_match_plain(cuda_device, n, depth, buckets, topk,
                                    cand, kind):
    """K13 (sketch update and live count), K14 (query and candidate
    pool) and K15 (top-k merge) against their plain versions on the
    card, three steps from one prior state: every leaf bit-exact.
    ``cand`` 0 takes the largest pool the kernel allows (past K15's
    limit: the merge is left out)."""
    from distributed_embeddings_torch.ops import sketch as sk

    merge = cand > 0
    if not merge:
        cand = sk._pool_max()
        assert cand >= 4096
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
