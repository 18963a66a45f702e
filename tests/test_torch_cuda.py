"""The port's kernels on the card, against their plain PyTorch versions.

Marked ``cuda``: they skip without a card. On the GPU, where JAX is not
installed, run them without the suite's JAX conftest::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the hotness-1 gather and the bottom-row copy of the
interaction are bit-exact; fp32-accumulated sums (hotness 3, weights,
the pair dot products) are within 1 bf16 ulp of the plain result (bf16)
or 1e-6 / 1e-5 relative (fp32), since the kernel sums in another order.
"""

import numpy as np
import pytest
import torch

from distributed_embeddings_torch.models import DLRMConfig, DLRMDense
from distributed_embeddings_torch.ops import (
    dot_interact_fwd, dot_interact_fwd_plain, embedding_lookup,
    gather_combine, gather_combine_plain)
from distributed_embeddings_torch.parallel import (
    DistributedEmbedding, HybridTrainState, ServeConfig, Served,
    ServingRuntime, synthetic_request)

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
