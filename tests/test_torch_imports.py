"""Guard: the port stands alone and never falls back silently.

AST-scans every module of ``distributed_embeddings_torch/``,
``chip_smoke.py`` and the world-8 tests' rank worker
(``tests/torch_dist_worker.py``, which the ranks import):

* no import of ``jax``, ``flax``, ``optax``, ``msgpack``, ``ml_dtypes``,
  ``absl``, ``distributed_embeddings_tpu`` or ``tools`` (the port keeps
  its own copy of what it needs; the card's machine has none of them);
* no ``try``/``except`` whose handler calls a kernel's plain version
  (``*_plain``): a CUDA tensor launches the kernel or raises.

The checker itself is held to seeded violations, so a broken scan
cannot pass vacuously.
"""

import ast
import os
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "flax", "optax", "msgpack", "ml_dtypes", "absl",
             "distributed_embeddings_tpu", "tools")


def _sources():
    files = sorted((ROOT / "distributed_embeddings_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files.append(ROOT / "tests" / "torch_dist_worker.py")
    return files


def _called_names(nodes):
    out = set()
    for node in nodes:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                f = sub.func
                if isinstance(f, ast.Name):
                    out.add(f.id)
                elif isinstance(f, ast.Attribute):
                    out.add(f.attr)
    return out


def violations(source: str, name: str = "<src>"):
    """Forbidden imports and plain-version fallbacks in ``source``."""
    found = []
    for node in ast.walk(ast.parse(source, name)):
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        for m in mods:
            if m.split(".")[0] in FORBIDDEN:
                found.append(f"{name}:{node.lineno}: imports {m}")
        if isinstance(node, ast.Try):
            plain = sorted(n for n in _called_names(node.handlers)
                           if n.endswith("_plain"))
            if plain:
                found.append(f"{name}:{node.lineno}: an except handler "
                             f"falls back to {plain}")
    return found


def test_sources_exist():
    names = {p.name for p in _sources()}
    assert {"chip_smoke.py", "_kernels.py", "embedding_lookup.py",
            "interaction.py", "serving.py", "scatter_add.py",
            "optimizers.py", "apply.py", "trainer.py", "obs.py",
            "sparse_grad.py", "adagrad.py", "synthetic.py",
            "synthetic_configs.py", "packed_slab.py", "convert.py",
            "lookup.py", "exchange.py", "dist_embedding.py", "adam.py",
            "momentum.py", "learnable.py", "schedules.py",
            "metrics.py", "sketch.py", "telemetry.py",
            "streaming.py"} <= names
    # the telemetry and streaming slices' modules are scanned too
    scanned = {str(p.relative_to(ROOT)) for p in _sources()}
    assert {"distributed_embeddings_torch/analysis/__init__.py",
            "distributed_embeddings_torch/analysis/telemetry.py",
            "distributed_embeddings_torch/ops/sketch.py",
            "distributed_embeddings_torch/ops/streaming.py",
            "distributed_embeddings_torch/parallel/streaming.py",
            "distributed_embeddings_torch/utils/checkpoint.py",
            "distributed_embeddings_torch/utils/msgpack_state.py",
            "distributed_embeddings_torch/utils/runtime.py",
            "distributed_embeddings_torch/utils/data.py",
            "distributed_embeddings_torch/examples/dlrm_main.py",
            "distributed_embeddings_torch/ops/exchange_pack.py",
            "distributed_embeddings_torch/parallel/bootstrap.py",
            "distributed_embeddings_torch/parallel/grads.py",
            "tests/torch_dist_worker.py"} <= scanned


def test_every_kernel_source_is_bound():
    """Each ``csrc/*.cu`` has its C signatures in ``ops/_kernels.py``
    (so it builds and loads), and each signature's source exists."""
    from distributed_embeddings_torch.ops import _kernels

    cu = {p.stem for p in (ROOT / "distributed_embeddings_torch" / "csrc"
                           ).glob("*.cu")}
    assert cu == set(_kernels.SIGNATURES)
    assert {"csr", "ragged_combine", "ragged_grad", "adam",
            "momentum", "sketch", "streaming", "sgd_promoted",
            "exchange_pack"} <= cu


def test_library_name_follows_included_headers(tmp_path, monkeypatch):
    """A library is named by its source and every local header the
    source includes (followed through headers), so an edited header
    never loads a stale build. Hashing only: no nvcc."""
    from distributed_embeddings_torch.ops import _kernels

    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <x.h>\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// v1\n")
    monkeypatch.setattr(_kernels, "CSRC", str(tmp_path))
    names = [_kernels._lib_path("k")]
    for f, text in (("b.cuh", "// v2\n"), ("a.cuh", "#include \"b.cuh\"\n"),
                    ("k.cu", '#include "a.cuh"\n')):
        (tmp_path / f).write_text(text)
        names.append(_kernels._lib_path("k"))
    assert len(set(names)) == len(names)
    (tmp_path / "b.cuh").write_text("// v1\n")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <x.h>\n')
    assert _kernels._lib_path("k") == names[0]
    # the real sources: the shared headers are part of the libraries that
    # include them, and of no other
    monkeypatch.undo()
    with open(os.path.join(_kernels.CSRC, "radix_sort.cuh"), "rb") as f:
        header = f.read()
    for name, included in (("dedup", True), ("sgd_promoted", True),
                           ("sketch", False)):
        src = _kernels.source_bytes(os.path.join(_kernels.CSRC,
                                                 name + ".cu"))
        assert (header in src) == included, name


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_is_standalone(path):
    assert violations(path.read_text(), str(path.relative_to(ROOT))) == []


@pytest.mark.parametrize("bad", [
    "import jax\n",
    "import jax.numpy as jnp\n",
    "from flax import linen\n",
    "import optax\n",
    "from distributed_embeddings_tpu.parallel import plan\n",
    "from tools._profcommon import CRITEO_1TB_SIZES\n",
    "def f(x):\n    try:\n        return gather_combine(x)\n"
    "    except RuntimeError:\n        return gather_combine_plain(x)\n",
    "def f(x):\n    try:\n        return k.dot_interact_fwd(x)\n"
    "    except Exception:\n        return ops.dot_interact_fwd_plain(x)\n",
    "def f(s, i, v):\n    try:\n        return sgd_scatter(s, i, v, .1)\n"
    "    except RuntimeError:\n"
    "        return sgd_scatter_plain(s, i, v, .1)\n",
    "def g(f, d):\n    try:\n        return dot_interact_bwd(f, d)\n"
    "    except (RuntimeError, OSError):\n"
    "        return dot_interact_bwd_plain(f, d)\n",
    "def h(i, v):\n    try:\n        return dedup_sparse_grad(i, v, pad_id=9)\n"
    "    except RuntimeError:\n"
    "        return dedup_sparse_grad_plain(i, v, pad_id=9)\n",
    "def h(s, a, u, g):\n    try:\n"
    "        return adagrad_rows(s, a, u, g, .1, 1e-7)\n"
    "    except RuntimeError:\n"
    "        return adagrad.adagrad_rows_plain(s, a, u, g, .1, 1e-7)\n",
    "def h(s, a, g):\n    try:\n        return adagrad_dense(s, a, g, .1, 0.)\n"
    "    except Exception:\n        return adagrad_dense_plain(s, a, g, .1, 0.)\n",
    "from distributed_embeddings_tpu.models.synthetic_configs import "
    "model_tiny\n",
    "import distributed_embeddings_tpu.ops.sparse_grad as sparse_grad\n",
    "from distributed_embeddings_tpu.ops.embedding_lookup import "
    "row_to_split\n",
    "from distributed_embeddings_tpu.parallel.lookup import csr_seg\n",
    "def f(s, v, sp, r, o):\n    try:\n"
    "        return ragged_combine(s, v, sp, r, o)\n"
    "    except RuntimeError:\n"
    "        return ragged_combine_plain(s, v, sp, r, o)\n",
    "def f(g, sp):\n    try:\n        return ops.ragged_grad(g, sp, cap=4)\n"
    "    except (RuntimeError, ValueError):\n"
    "        return ops.ragged_grad_plain(g, sp, cap=4)\n",
    "def f(n):\n    try:\n        return lengths_to_splits(n)\n"
    "    except Exception:\n        return lengths_to_splits_plain(n)\n",
    "def f(i):\n    try:\n        return el.row_to_split(i, 8)\n"
    "    except OSError:\n        return el.row_to_split_plain(i, 8)\n",
    "def f(s):\n    try:\n        return ragged_row_ids(s, 8)\n"
    "    except RuntimeError:\n        return ragged_row_ids_plain(s, 8)\n",
    "def f(*a):\n    try:\n        return adam_rows(*a)\n"
    "    except RuntimeError:\n        return adam.adam_rows_plain(*a)\n",
    "def f(*a):\n    try:\n        return ops.momentum_rows(*a)\n"
    "    except (OSError, RuntimeError):\n"
    "        return momentum_rows_plain(*a)\n",
    "from distributed_embeddings_tpu.models.learnable import "
    "LearnableClicks\n",
    "from distributed_embeddings_tpu.utils.metrics import binary_auc\n",
    "from distributed_embeddings_tpu.analysis import telemetry\n",
    "from distributed_embeddings_tpu.utils.envvars import declare\n",
    "def f(c, i, v):\n    try:\n        return cms_update(c, i, v)\n"
    "    except RuntimeError:\n        return cms_update_plain(c, i, v)\n",
    "def f(*a):\n    try:\n        return ops.topk_merge(*a)\n"
    "    except Exception:\n        return topk_merge_plain(*a)\n",
    "import msgpack\n",
    "from flax import serialization\n",
    "import ml_dtypes\n",
    "from absl import flags\n",
    "from distributed_embeddings_tpu.utils import checkpoint\n",
    "def f(*a):\n    try:\n        return sgd_scatter_promoted(*a)\n"
    "    except RuntimeError:\n"
    "        return sgd_scatter_promoted_plain(*a)\n",
])
def test_checker_catches_seeded_violations(bad):
    assert violations(bad)


def test_checker_allows_relative_and_plain_calls_outside_handlers():
    ok = ("from .ops import gather_combine_plain\n"
          "import torch\n"
          "def f(x):\n    if x.is_cpu:\n        return gather_combine_plain(x)\n"
          "    try:\n        return g(x)\n    finally:\n        pass\n")
    assert violations(ok) == []
