"""The list-form dot interaction (K2 forward, K4 backward; their plain
versions on the CPU) against the JAX package's
``models/dlrm.py:dot_interact`` and its ``jax.vjp``, per input.

The port's ``models.dlrm.dot_interact`` hands the features to
``DotInteract`` as they are (no stack): ``dot_interact_fwd`` takes a list
of ``[B, D]`` tensors, ``dot_interact_bwd`` returns one gradient a
feature. Held here, on the same numpy inputs (seeded), for bf16 and fp32,
F in {2, 5, 27} and D in {13, 16, 128}:

  - forward, fp32: within 1e-5 of the sum of |products| of each pair
    (the relative form of rtol 1e-5 that holds a dot product that
    cancels: both sum in fp32, in their own orders);
  - forward, bf16: each side within 1 bf16 ulp of the value its fp32
    accumulation rounds (the exact sum of the bf16 products) plus the
    fp32 order term 2^-20 of the sum of |products|; the appended
    bottom-MLP row bit-exact;
  - backward, fp32: within 1e-5 of the sum of |terms| of each output
    (``sum_g |dG[f, g]| |x_g|``, plus the appended row's cotangent on
    feature 0); bf16: within 2 bf16 ulps of that sum (JAX rounds the two
    einsum cotangents, their sum and the appended row's add, the port
    once);
  - each tolerance has a control that must fail it: the forward with two
    pairs swapped in the triangle order, the backward with the appended
    row's cotangent dropped.

Also held: features given as strided views (the column slices of one
``[B, 26 D]`` tensor) give bit-identical results to the stacked form,
while a transposed view, a feature whose rows are not 16-B aligned on
the tensor-core shapes and mismatched features raise; and the launch-
record keys of both wrappers, built without a card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.models import dot_interact as jax_dot_interact

from distributed_embeddings_torch.models import dot_interact
from distributed_embeddings_torch.ops import _kernels
from distributed_embeddings_torch.ops import interaction as it
from distributed_embeddings_torch.ops.interaction import (
    DotInteract, dot_interact_bwd, dot_interact_bwd_plain, dot_interact_fwd,
    dot_interact_fwd_plain)

from torch_parity import bf16_ulp, to_np

torch.set_num_threads(1)

B = 24
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(f, d) for f in (2, 5, 27) for d in (13, 16, 128)]


@functools.lru_cache(maxsize=None)
def _jax_fns(f, dtype):
    """The JAX function and its vjp, jitted once per feature count and
    dtype (the shapes are traced per call signature)."""

    def fwd(bottom, embs):
        return jax_dot_interact(list(embs), bottom)

    def vjp(bottom, embs, dy):
        _, pull = jax.vjp(fwd, bottom, embs)
        return pull(dy)

    return jax.jit(fwd), jax.jit(vjp)


def _inputs(f, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, f, d)).astype(np.float32)
    dy = rng.normal(size=(B, f * (f - 1) // 2 + d)).astype(np.float32)
    return x, dy


def _rounded(a, tdt):
    """``a`` rounded to ``tdt`` as both frameworks round it, in float64."""
    return to_np(torch.from_numpy(a).to(tdt)).astype(np.float64)


def _fwd_scale(q):
    """Per output: the sum of |products| of each pair, then |x_0|."""
    f = q.shape[1]
    li, lj = np.tril_indices(f, k=-1)
    return np.concatenate(
        [np.einsum("bpd,bpd->bp", np.abs(q[:, li]), np.abs(q[:, lj])),
         np.abs(q[:, 0])], axis=1)


def _fwd_exact(q):
    """The exact pair sums of the rounded inputs (float64), then x_0."""
    f = q.shape[1]
    li, lj = np.tril_indices(f, k=-1)
    return np.concatenate([np.einsum("bpd,bpd->bp", q[:, li], q[:, lj]),
                           q[:, 0]], axis=1)


def _fwd_within(got, want, q, dtype):
    """Whether ``got`` meets the forward tolerance against ``want`` (JAX)
    on the rounded inputs ``q``."""
    scale = _fwd_scale(q)
    if dtype == "float32":
        return bool((np.abs(got - want) <= 1e-5 * scale + 1e-30).all())
    exact = _fwd_exact(q)
    tol = bf16_ulp(exact) + 2.0 ** -20 * scale
    return bool((np.abs(got - exact) <= tol).all()
                and (np.abs(want - exact) <= tol).all())


def _bwd_scale(q, qd):
    b, f, _ = q.shape
    p = f * (f - 1) // 2
    li, lj = np.tril_indices(f, k=-1)
    adg = np.zeros((b, f, f))
    adg[:, li, lj] = np.abs(qd[:, :p])
    adg[:, lj, li] = np.abs(qd[:, :p])
    scale = np.einsum("bfg,bgd->bfd", adg, np.abs(q))
    scale[:, 0] += np.abs(qd[:, p:])
    return scale


def _bwd_within(got, want, scale, dtype):
    if dtype == "float32":
        return bool((np.abs(got - want) <= 1e-5 * scale + 1e-30).all())
    return bool((np.abs(got - want) <= 2 * bf16_ulp(np.maximum(
        scale, 1e-30))).all())


def _features(x, tdt, requires_grad=False):
    """The port's list form: feature 0 the bottom-MLP output, each a
    ``[B, D]`` tensor of its own."""
    return [torch.from_numpy(x[:, k].copy()).to(tdt).requires_grad_(
        requires_grad) for k in range(x.shape[1])]


@pytest.mark.parametrize("f,d", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_list_forward_matches_jax(dtype, f, d):
    jdt, tdt = DTYPES[dtype]
    x, _ = _inputs(f, d, seed=f * 1000 + d)
    jfwd, _ = _jax_fns(f, dtype)
    jx = jnp.asarray(x, jdt)
    want = to_np(jfwd(jx[:, 0], tuple(jx[:, k] for k in range(1, f))))
    feats = _features(x, tdt)
    got = to_np(dot_interact(feats[1:], feats[0]))
    assert got.shape == want.shape == (B, f * (f - 1) // 2 + d)
    np.testing.assert_array_equal(
        to_np(dot_interact_fwd(feats)), got)  # the wrapper, the same bits
    q = _rounded(x, tdt)
    np.testing.assert_array_equal(got[:, -d:], want[:, -d:])
    assert _fwd_within(got, want, q, dtype)
    # control: outputs 0 and 1 swapped (pairs (1, 0) and (2, 0); F = 2 has
    # one pair, swapped with the first appended column) must fail
    bad = got.copy()
    bad[:, [0, 1]] = bad[:, [1, 0]]
    assert not _fwd_within(bad, want, q, dtype)


@pytest.mark.parametrize("f,d", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_list_backward_matches_jax_vjp(dtype, f, d):
    """``DotInteract`` over the list: each input's gradient (the
    bottom-MLP output's and every embedding output's) against JAX's vjp."""
    jdt, tdt = DTYPES[dtype]
    x, dy = _inputs(f, d, seed=f * 1000 + d + 7)
    _, jvjp = _jax_fns(f, dtype)
    jx = jnp.asarray(x, jdt)
    d_bottom, d_embs = jvjp(jx[:, 0], tuple(jx[:, k] for k in range(1, f)),
                            jnp.asarray(dy, jdt))
    want = np.stack([to_np(d_bottom)] + [to_np(e) for e in d_embs], axis=1)
    feats = _features(x, tdt, requires_grad=True)
    tdy = torch.from_numpy(dy).to(tdt)
    DotInteract.apply(*feats).backward(tdy)
    got = np.stack([to_np(t.grad) for t in feats], axis=1)
    assert got.shape == want.shape == (B, f, d)
    scale = _bwd_scale(_rounded(x, tdt), _rounded(dy, tdt))
    assert _bwd_within(got, want, scale, dtype)
    # the wrapper: one contiguous [B, D] view a feature, of one buffer
    plain = [t.detach() for t in feats]
    grads = dot_interact_bwd(plain, tdy)
    assert len(grads) == f and all(g.is_contiguous() for g in grads)
    assert len({g.untyped_storage().data_ptr() for g in grads}) == 1
    np.testing.assert_array_equal(np.stack([to_np(g) for g in grads], 1),
                                  got)
    # control: the appended row's cotangent dropped must fail
    cut = tdy.clone()
    cut[:, f * (f - 1) // 2:] = 0
    dropped = np.stack([to_np(g) for g in dot_interact_bwd(plain, cut)], 1)
    assert not _bwd_within(dropped, want, scale, dtype)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("d", [13, 16, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_views_match_the_stacked_form(dtype, d):
    """Features as the column slices of one ``[B, 26 D]`` tensor (and the
    bottom output beside it) give the stacked form's bits, both ways."""
    rng = np.random.default_rng(d)
    wide = torch.from_numpy(rng.normal(size=(B, 26 * d)).astype(
        np.float32)).to(dtype)
    bottom = torch.from_numpy(rng.normal(size=(B, d)).astype(
        np.float32)).to(dtype)
    feats = [bottom] + [wide[:, k * d:(k + 1) * d] for k in range(26)]
    assert all(not t.is_contiguous() for t in feats[1:])
    stacked = torch.stack(feats, dim=1)
    got = dot_interact_fwd(feats)
    want = dot_interact_fwd(stacked)
    assert torch.equal(_bits(got), _bits(want))
    dy = torch.from_numpy(rng.normal(size=tuple(got.shape)).astype(
        np.float32)).to(dtype)
    grads = dot_interact_bwd(feats, dy)
    whole = dot_interact_bwd(stacked, dy)
    for k, g in enumerate(grads):
        assert torch.equal(_bits(g), _bits(whole[:, k]))
    # through the model's function too
    assert torch.equal(_bits(dot_interact(feats[1:], feats[0])), _bits(want))


def test_layouts_the_kernels_do_not_take_raise():
    """A transposed view, a misaligned bf16 row on the tensor-core
    shapes and mismatched features raise a ``ValueError`` that names the
    feature; nothing is copied to make them fit."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(B, 5, 16)).astype(np.float32))
    feats = list(x.unbind(1))
    t_view = torch.from_numpy(rng.normal(size=(16, B)).astype(
        np.float32)).t()
    assert t_view.shape == (B, 16)
    with pytest.raises(ValueError, match="feature 3.*not contiguous"):
        dot_interact_fwd(feats[:3] + [t_view] + feats[4:])
    # a stack is taken as its views: the first names feature 0
    with pytest.raises(ValueError, match="feature 0.*not contiguous"):
        dot_interact_fwd(x.transpose(1, 2))
    with pytest.raises(ValueError, match="feature 2.*not contiguous"):
        dot_interact_bwd(feats[:2] + [t_view] + feats[3:],
                         torch.zeros(B, 10 + 16))
    wide = torch.zeros(B, 40, dtype=torch.bfloat16)
    mis = wide[:, 1:17]  # 2 bytes off a 16-B boundary
    assert mis.data_ptr() % 16 == 2
    bf = [t.to(torch.bfloat16) for t in feats]
    with pytest.raises(ValueError, match="feature 1's rows are not 16-B"):
        dot_interact_fwd([bf[0], mis] + bf[2:])
    # the same offset on a CUDA-core shape (D = 13) is taken as it is
    odd = [torch.zeros(B, 13, dtype=torch.bfloat16) for _ in range(4)]
    assert dot_interact_fwd([odd[0], wide[:, 1:14]] + odd[2:]).shape == (
        B, 6 + 13)
    with pytest.raises(ValueError, match="feature 2 must be"):
        dot_interact_fwd(feats[:2] + [feats[2][:, :8]] + feats[3:])
    with pytest.raises(ValueError, match="feature 1 is torch.float64"):
        dot_interact_fwd([feats[0], feats[1].double()] + feats[2:])
    with pytest.raises(ValueError, match="2..255 features"):
        dot_interact_fwd(feats[:1])
    with pytest.raises(ValueError, match="dy must be"):
        dot_interact_bwd(feats, torch.zeros(B, 7))


def test_more_features_than_the_table_on_the_cpu():
    """Past 32 features the list still gives the stacked form's values
    (the card stacks it once for the CUDA-core kernels)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(6, 40, 8)).astype(np.float32))
    feats = list(x.unbind(1))
    np.testing.assert_array_equal(to_np(dot_interact_fwd(feats)),
                                  to_np(dot_interact_fwd_plain(x)))
    dy = torch.from_numpy(rng.normal(size=(6, 780 + 8)).astype(np.float32))
    got = np.stack([to_np(g) for g in dot_interact_bwd(feats, dy)], 1)
    np.testing.assert_array_equal(got, to_np(dot_interact_bwd_plain(x, dy)))


# ------------------------------------------------ the launch-record keys


def _step_feats(b=8, d=16, dtype=torch.bfloat16):
    """The features as the step hands them over: the bottom output and
    26 pieces of one embedding buffer."""
    buf = torch.zeros(26 * b * d, dtype=dtype)
    return tuple([torch.zeros(b, d, dtype=dtype)]
                 + [buf[k * b * d:(k + 1) * b * d].view(b, d)
                    for k in range(26)])


def test_fwd_record_is_found_again_and_rebuilt_on_every_changed_fact():
    cache = _kernels.LaunchCache()
    feats = _step_feats()
    rec = it.find_fwd_record(cache, feats, build_on_cpu=True)
    assert cache.builds == 1 and rec.calls == ()
    assert rec.payload[:3] == ((8, 351 + 16), torch.bfloat16,
                               torch.device("cpu"))
    assert it.find_fwd_record(cache, feats, build_on_cpu=True) is rec
    assert it.find_fwd_record(cache, list(feats), build_on_cpu=True) is rec
    assert cache.builds == 1
    # one feature's address, one feature's stride, the dtype, every
    # stride, the batch: each rebuilds
    changes = [
        feats[:5] + (feats[5].clone(),) + feats[6:],
        feats[:5] + (torch.zeros(8, 32, dtype=torch.bfloat16)[:, :16],)
        + feats[6:],
        tuple(t.float() for t in feats),
        feats[:1] + tuple(torch.zeros(8, 32, dtype=torch.bfloat16)[:, :16]
                          for _ in range(26)),
        tuple(t[:4] for t in feats)]
    for k, ch in enumerate(changes):
        got = it.find_fwd_record(cache, ch, build_on_cpu=True)
        assert got is not rec and cache.builds == 2 + k
    # a stack is taken as its 27 views (a record of its own); more
    # features than the table as one tensor
    x = it._as_form(torch.stack(feats, dim=1))
    assert it.find_fwd_record(cache, x, build_on_cpu=True).payload[0] == (
        8, 351 + 16)
    assert cache.builds == 2 + len(changes)
    wide = it._as_form(torch.zeros(8, 40, 16, dtype=torch.bfloat16))
    assert it.find_fwd_record(cache, wide, build_on_cpu=True).payload[0] == (
        8, 780 + 16)
    assert it.fwd_record_key(x)[0] == 27 and it.fwd_record_key(wide)[0] == 1


def test_fwd_key_holds_every_feature_fact():
    """Each feature's address, shape, strides and dtype (its device
    follows from its address)."""
    feats = _step_feats()
    key = it.fwd_record_key(feats)
    full = _kernels.tensor_key(feats)
    assert key == (27, *full[:4 * 27])
    assert len(key) == 1 + 4 * 27


def test_bwd_record_keys_dy_layout_and_alignment_not_its_address():
    cache = _kernels.LaunchCache()
    feats = _step_feats()
    dy = torch.zeros(8, 351 + 16, dtype=torch.bfloat16)
    rec = it.find_bwd_record(cache, feats, dy, build_on_cpu=True)
    assert rec.payload[0] == (27, 8, 16) and rec.payload[4] is True
    # a new dy of the same layout (and alignment) is a hit
    dy2 = torch.zeros(8, 351 + 16, dtype=torch.bfloat16)
    assert dy2.data_ptr() % 16 == 0
    assert it.find_bwd_record(cache, feats, dy2, build_on_cpu=True) is rec
    assert cache.builds == 1
    # a dy 2 bytes off a 16-B boundary rebuilds (the tensor-core K4 loads
    # its rows in 16-B chunks)
    wide = torch.zeros(8 * (351 + 16) + 1, dtype=torch.bfloat16)
    mis = wide[1:].view(8, 351 + 16)
    assert it.bwd_record_key(feats, mis) != it.bwd_record_key(feats, dy)
    assert it.find_bwd_record(cache, feats, mis,
                              build_on_cpu=True) is not rec
    # past the table (a [B, F, D] tensor) the output is [B, F, D]
    x = it._as_form(torch.zeros(8, 40, 16, dtype=torch.bfloat16))
    srec = it.find_bwd_record(
        cache, x, torch.zeros(8, 780 + 16, dtype=torch.bfloat16),
        build_on_cpu=True)
    assert srec.payload[0] == (8, 40, 16) and srec.payload[4] is False
    with pytest.raises(ValueError, match="dy must be a contiguous"):
        it.find_bwd_record(cache, feats, dy.t().contiguous().t(),
                           build_on_cpu=True)


def test_bwd_record_found_through_the_forward_record():
    """``DotInteract``'s backward keys K4's record by K2's record of the
    same features and dy's layout: a new dy of that layout is a hit, a
    dy off a 16-B boundary or another forward record rebuilds, and the
    record is the one the features' own key builds."""
    cache, fwd = _kernels.LaunchCache(), _kernels.LaunchCache()
    feats = _step_feats()
    rec = it.find_fwd_record(fwd, feats, build_on_cpu=True)
    dy = torch.zeros(8, 351 + 16, dtype=torch.bfloat16)

    def find(r, d):
        return it.find_bwd_record(cache, feats, d, build_on_cpu=True,
                                  key=(r, *it._dy_key(d)))

    brec = find(rec, dy)
    assert brec.payload[:5] == it.find_bwd_record(
        _kernels.LaunchCache(), feats, dy, build_on_cpu=True).payload[:5]
    assert find(rec, torch.zeros_like(dy)) is brec and cache.builds == 1
    wide = torch.zeros(8 * (351 + 16) + 1, dtype=torch.bfloat16)
    assert find(rec, wide[1:].view(8, 351 + 16)) is not brec
    other = it.find_fwd_record(fwd, tuple(t.clone() for t in feats),
                               build_on_cpu=True)
    assert find(other, dy) is not brec and cache.builds == 3


def test_cpu_wrappers_keep_no_record_and_still_check():
    before = (len(it._FWD.records), len(it._BWD.records))
    feats = _step_feats(d=13, dtype=torch.float32)
    out = dot_interact_fwd(feats)
    dot_interact_bwd(feats, torch.zeros_like(out))
    assert (len(it._FWD.records), len(it._BWD.records)) == before
    with pytest.raises(ValueError, match="not contiguous"):
        dot_interact_fwd(feats[:1] + (torch.zeros(13, 8).t(),) + feats[2:])


def test_kernel_view_of_the_features():
    """The table a launch gets: each feature's address and row stride
    (elements) for the list form, base / row / feature stride for the
    stack."""
    feats = _step_feats(b=8, d=16)
    ptrs, strides, n_table, fstride = it._rows(feats)
    assert n_table == 27 and fstride == 0
    assert list(ptrs) == [t.data_ptr() for t in feats]
    assert list(strides) == [16] * 27
    wide = torch.zeros(8, 26 * 16, dtype=torch.bfloat16)
    cols = (feats[0],) + tuple(wide[:, k * 16:(k + 1) * 16]
                               for k in range(26))
    ptrs, strides, _, _ = it._rows(cols)
    assert list(strides[1:]) == [26 * 16] * 26
    assert list(np.diff(ptrs[1:])) == [32] * 25
    # a stack up to the table's size is its views; past it, one tensor
    x = torch.zeros(8, 27, 16, dtype=torch.bfloat16)
    ptrs, strides, n_table, fstride = it._rows(it._as_form(x))
    assert (n_table, list(strides), fstride) == (27, [27 * 16] * 27, 0)
    assert list(ptrs) == [x.data_ptr() + 32 * k for k in range(27)]
    x = torch.zeros(8, 40, 16, dtype=torch.bfloat16)
    ptrs, strides, n_table, fstride = it._rows(it._as_form(x))
    assert (n_table, list(strides), fstride) == (0, [40 * 16], 16)
    assert list(ptrs) == [x.data_ptr()]
