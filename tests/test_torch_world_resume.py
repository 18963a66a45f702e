"""Resuming at world 8, and the streaming and telemetry state files
beside the checkpoints: the port's eight gloo ranks
(``torch_dist_worker.py:case_ckpt``, one group for the file) against
the JAX package on its 8-device CPU mesh.

* Resume: from one JAX checkpoint, 4 uninterrupted steps against 2
  steps, a save, a restore and 2 more: on every rank the losses, slabs,
  optimizer state, dense parameters and step bitwise equal (float32
  tables on a row-sliced plan, bf16 tables under the schedule, Adam).
  Control: the state the restore gives at step 2 differs from both.
* The streaming codec: ``encode_state`` at world 8 (a collective)
  equals JAX's encoding of the same ``[8, ...]`` state key for key, in
  JAX's order, bit for bit, on every rank; ``decode_state`` gives every
  rank JAX's row. The state rides the checkpoint (``aux/streaming.npz``)
  and comes back as JAX's decode of it (the home rank's slot maps, every
  rank's sketch and counters), a re-save of the restored state
  reproducing every CRC (JAX's ``test_save_restore_roundtrip_bitwise``). Then 8 -> 1
  -> 8 (JAX's ``test_reshard_8_4_8_roundtrip_bitwise``): the slot maps
  carry over intact both ways, the per-rank sketches and counters reset
  with JAX's warning, every rank's row equal to JAX's decode of the
  world-1 encoding.
* The telemetry state file: the port's world-8 file holds JAX's leaves
  bit for bit; JAX's file restores into every rank's row; a world-1
  file gives the fresh state at world 8.

The streaming and telemetry states are random values in the states'
shapes and dtypes (the codecs read no semantics). Every check is exact.
"""

import os

import jax
import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.analysis import telemetry as jtel
from distributed_embeddings_tpu.models.dlrm import DLRMConfig as JaxConfig
from distributed_embeddings_tpu.parallel import DistributedEmbedding as JaxDE
from distributed_embeddings_tpu.parallel import streaming as jstream
from distributed_embeddings_tpu.utils import checkpoint as jax_ckpt

from distributed_embeddings_torch.analysis import telemetry as tel
from distributed_embeddings_torch.models import DLRMConfig, DLRMDense
from distributed_embeddings_torch.parallel import (DistributedEmbedding,
                                                   StreamingConfig,
                                                   init_streaming)
from distributed_embeddings_torch.parallel import streaming as smod
from distributed_embeddings_torch.utils import checkpoint as ckpt
from distributed_embeddings_torch.utils.convert import (
    streaming_state_to_numpy)

from torch_dist_worker import RankGroup, ckpt_optimizers
from torch_world_ref import (CKPT_MODEL, CKPT_SCHED, WORLD,
                             assert_tree_rows_equal,
                             ckpt_spec, jax_ckpt_parts, jax_ckpt_state,
                             mesh)

torch.set_num_threads(1)

STREAM = {9: {"capacity": 40, "buckets": 5}}  # table 9: 45 rows
SCFG = (2, 1, 2, 64)  # admit_min_count, evict_margin, depth, buckets
TCFG = (2, 128, 8, 16)  # depth, buckets, topk, candidates


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = RankGroup(WORLD, tmp_path_factory.mktemp("gloo_world_resume"))
    yield g
    g.close()


def _equal_snaps(a, b):
    if a["step"] != b["step"] or sorted(a["emb"]) != sorted(b["emb"]):
        return False
    pairs = [(a["emb"][k], b["emb"][k]) for k in a["emb"]]
    pairs += list(zip(a["opt"], b["opt"])) + list(zip(a["dense"],
                                                      b["dense"]))
    pairs += list(zip(a["dense_opt"], b["dense_opt"]))
    return all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in pairs)


@pytest.mark.parametrize("case", ["rowslice", "sgd_bf16", "adam"])
def test_world8_resume_equals_uninterrupted(group, tmp_path, case):
    J, P = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save_train_state(J, jax_ckpt_parts(case)[0],
                              jax_ckpt_state(case, seed=3))
    ranks = group.run("ckpt", ckpt_spec(case, ops=[
        ("restore", J, "error", {}), ("steps", 4, "full"), ("snap", "A"),
        ("restore", J, "error", {}), ("seek", 0), ("steps", 2, "first"),
        ("save", P, {}), ("restore", P, "error", {}), ("snap", "mid"),
        ("steps", 2, "rest"), ("snap", "B")]))
    for r, got in enumerate(ranks):
        assert "error" not in got, got.get("error")
        assert got["first"] + got["rest"] == got["full"], r
        assert np.isfinite(got["full"]).all()
        assert got["B"]["step"] == 11
        assert _equal_snaps(got["A"], got["B"]), f"rank {r}"
        assert not _equal_snaps(got["A"], got["mid"]), f"rank {r}"
    for a, b in zip(ranks[0]["A"]["tables"], ranks[0]["B"]["tables"]):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ streaming state


def _configs():
    configs = JaxConfig(**CKPT_MODEL).embedding_configs()
    for t, sc in STREAM.items():
        configs[t]["streaming"] = dict(sc)
    return configs


def _jde(world=WORLD):
    return JaxDE(_configs(), world_size=world, strategy="memory_balanced")


def _random_state(tree, rng, free=None):
    """Random values in the shapes and dtypes of a JAX state (numpy);
    ``slot_fp`` leaves 31-bit fingerprints, a third of them free."""
    def fill(path, a):
        a = np.asarray(a)
        name = str(path[-1])
        if a.dtype == np.int32 and "slot_fp" in name:
            v = rng.integers(0, 2 ** 31 - 1, a.shape).astype(np.int32)
            v[rng.random(a.shape) < 1 / 3] = free
            return v
        if a.dtype == np.int32:
            return rng.integers(0, 1000, a.shape).astype(np.int32)
        return np.round(rng.random(a.shape) * 100).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _np(tree):
    return jax.tree.map(np.array, tree)


def _stream_spec(**kw):
    return ckpt_spec("sgd_bf16", streaming=STREAM, scfg=SCFG, tcfg=TCFG,
                     **kw)


def test_world8_streaming_codec_equals_jax(group, tmp_path):
    jde = _jde()
    scfg = jstream.StreamingConfig(*SCFG)
    init = jstream.init_streaming(jde, scfg, mesh=mesh())
    jst = _random_state(_np(init), np.random.default_rng(0),
                        jstream.SLOT_FREE)
    enc = jstream.encode_state(jde, jst)
    dec = _np(jstream.decode_state(jde, init, enc))
    P, P2 = str(tmp_path / "p"), str(tmp_path / "p2")
    ranks = group.run("ckpt", _stream_spec(ops=[
        ("init",), ("stream_from_jax", jst), ("encode", "enc"),
        ("decode", enc, "dec"), ("save_aux", P, {}),
        ("restore", P, "error", {}), ("load_aux", P, "rt"),
        ("save_aux", P2, {})]))
    for r, got in enumerate(ranks):
        assert "error" not in got, got.get("error")
        assert list(got["enc"]) == list(enc), r
        for k, v in enc.items():
            g = got["enc"][k]
            assert g.dtype == v.dtype and g.shape == v.shape, (r, k)
            np.testing.assert_array_equal(g, v, err_msg=f"rank {r} {k}")
        state, warnings = got["dec"]
        assert_tree_rows_equal(state, dec, r, "decode")
        assert_tree_rows_equal(got["rt"][0], dec, r, "roundtrip")
        assert not warnings and not got["rt"][1]
    meta, meta2 = (ckpt.verify_checkpoint(p) for p in (P, P2))
    assert meta["aux_states"] == ["streaming"]
    assert "aux/streaming.npz" in meta["files"]
    assert meta["files"] == meta2["files"]
    assert ckpt.load_aux_state(P, "streaming").keys() == enc.keys()


def test_world8_streaming_reshards_8_1_8(group, tmp_path, caplog):
    jde8 = _jde()
    scfg = jstream.StreamingConfig(*SCFG)
    init8 = jstream.init_streaming(jde8, scfg, mesh=mesh())
    jst = _random_state(_np(init8), np.random.default_rng(1),
                        jstream.SLOT_FREE)
    P8, P1 = str(tmp_path / "p8"), str(tmp_path / "p1")
    ranks = group.run("ckpt", _stream_spec(ops=[
        ("init",), ("stream_from_jax", jst), ("save_aux", P8, {})]))
    assert all("error" not in g for g in ranks)
    # world 1: the slot maps carry over, the sketch and counters reset
    de1 = DistributedEmbedding(
        [dict(c) for c in _configs()], world_size=1)
    emb_opt, tx, _ = ckpt_optimizers("sgd", CKPT_SCHED)
    dense = DLRMDense(DLRMConfig(**CKPT_MODEL), device="cpu",
                      generator=torch.Generator().manual_seed(9))
    st1 = ckpt.restore_train_state(P8, de1, emb_opt, dense, tx,
                                   device="cpu", on_mismatch="reshard")
    caplog.clear()
    ss1 = smod.decode_state(de1, init_streaming(
        de1, StreamingConfig(*SCFG), device="cpu"),
        ckpt.load_aux_state(P8, "streaming"))
    assert "re-shards from world/geometry" in caplog.text
    enc8 = jstream.encode_state(jde8, jst)
    enc1 = smod.encode_state(de1, ss1)
    for t in STREAM:
        for f in ("fp", "freq"):
            np.testing.assert_array_equal(enc1[f"t{t}_{f}"],
                                          enc8[f"t{t}_{f}"])
    host1 = streaming_state_to_numpy(ss1)
    assert not any(np.asarray(host1[n]).any() for n in
                   ("steps", "admitted", "evicted", "bucket_ids",
                    "hit_ids"))
    assert not host1["w8"]["cms"].any()
    ckpt.save_train_state(P1, de1, st1, aux_states={"streaming": enc1})
    # back at world 8: every rank's row is JAX's decode of that encoding
    want = _np(jstream.decode_state(jde8, init8, enc1))
    for t in STREAM:
        np.testing.assert_array_equal(
            jstream.encode_state(jde8, want)[f"t{t}_fp"], enc8[f"t{t}_fp"])
    ranks = group.run("ckpt", _stream_spec(ops=[
        ("restore", P1, "error", {"on_mismatch": "reshard"}),
        ("load_aux", P1, "back")]))
    for r, got in enumerate(ranks):
        assert "error" not in got, got.get("error")
        state, warnings = got["back"]
        assert_tree_rows_equal(state, want, r, "8 -> 1 -> 8")
        assert any("re-shards from world/geometry" in w for w in warnings)
        assert not state["w8"]["cms"].any()


# ------------------------------------------------------ telemetry state


def test_world8_telemetry_file_equals_jax(group, tmp_path):
    jde = _jde()
    tcfg = jtel.TelemetryConfig(*TCFG)
    fresh = _np(jtel.init_telemetry(jde, tcfg, mesh=mesh()))
    jt = _random_state(fresh, np.random.default_rng(2))
    FJ, FT, F1 = (str(tmp_path / n) for n in ("jax.npz", "port.npz",
                                              "w1.npz"))
    jtel.save_telemetry_state(FJ, jt)
    de1 = DistributedEmbedding([dict(c) for c in _configs()], world_size=1)
    tel.save_telemetry_state(F1, tel.init_telemetry(
        de1, tel.TelemetryConfig(*TCFG), device="cpu"))
    ranks = group.run("ckpt", _stream_spec(ops=[
        ("telem_from_jax", jt), ("telem_save", FT),
        ("telem_restore", FJ, "from_jax"),
        ("telem_restore", F1, "from_world1")]))
    with np.load(FJ) as a, np.load(FT) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for r, got in enumerate(ranks):
        assert "error" not in got, got.get("error")
        assert_tree_rows_equal(got["from_jax"], jt, r, "jax file")
        assert_tree_rows_equal(got["from_world1"], fresh, r, "world-1 file")
    assert not os.path.exists(FT + ".tmp")
