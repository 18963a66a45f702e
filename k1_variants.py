#!/usr/bin/env python3
"""K1's design choices timed against each other on one NVIDIA GPU.

Builds variants of ``distributed_embeddings_torch/csrc/gather_combine.cu``
(output rows a lane group R, threads a block, streaming output stores)
by patching a copy of the source (``variants.py``), each with ``nvcc``
into ``build/k1_variants/``, all builds at once; then times each at the
Criteo-1TB DLRM's training shapes (26 bf16 tables of width 128, b=65536,
hot 1 and hot 3 mean, Zipfian ids) with CUDA events, in turns (three
rounds, alternating the order), after checking that every variant gives
the same bits as the tree's K1. With ``--parent DIR`` (another checkout)
that checkout's ``gather_combine`` is timed in the same turns.

Run from the root of a checkout: ``python3 k1_variants.py [--parent DIR]``.
Prints the card's name and power limit, then one line a shape.
"""

import importlib
import importlib.util
import os
import sys

import numpy as np

import variants as vs

HERE = os.path.dirname(os.path.abspath(__file__))
#: name -> (rows a lane group, threads a block, streaming stores)
VARIANTS = {"r2_t128": (2, 128, False), "r1_t128": (1, 128, False),
            "r3_t128": (3, 128, False), "r4_t256": (4, 256, False),
            "r2_t256": (2, 256, False), "r2_t128_cs": (2, 128, True)}


def variant(rows, threads, streaming):
    """The source with another R, block size or output store."""
    subs = [("constexpr int kRows = 2;", f"constexpr int kRows = {rows};"),
            ("constexpr int kThreads = 128;",
             f"constexpr int kThreads = {threads};")]
    if streaming:
        subs.append(("*reinterpret_cast<RawT*>(out) = raw_out;",
                     "__stcs(reinterpret_cast<RawT*>(out), raw_out);"))
    return vs.replace(*subs)


def parent_gather(path):
    """``gather_combine`` of the checkout at ``path``, loaded as the
    package ``detpu_parent``."""
    root = os.path.join(os.path.abspath(path), "distributed_embeddings_torch")
    spec = importlib.util.spec_from_file_location(
        "detpu_parent", os.path.join(root, "__init__.py"),
        submodule_search_locations=[root])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["detpu_parent"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(
        "detpu_parent.ops.embedding_lookup").gather_combine


def main():
    import torch

    argv = sys.argv[1:]
    if argv and (len(argv) != 2 or argv[0] != "--parent"):
        raise SystemExit("usage: python3 k1_variants.py [--parent DIR]")
    if not torch.cuda.is_available():
        raise SystemExit("k1_variants: CUDA is not available")
    sys.path.insert(0, HERE)
    from chip_smoke import CRITEO_1TB_SIZES
    from distributed_embeddings_torch.ops import _kernels, gather_combine
    from distributed_embeddings_torch.utils.data import power_law_ids

    print(vs.card_line(), flush=True)
    libs = vs.build(_kernels, "gather_combine",
                    {name: variant(*v) for name, v in VARIANTS.items()},
                    "k1_variants")
    dev = torch.device("cuda")
    sizes = CRITEO_1TB_SIZES
    n, total = len(sizes), sum(sizes)
    slab = torch.empty((total, 128), dtype=torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for lo in range(0, total, 1 << 24):
        slab[lo:lo + (1 << 24)].normal_(generator=gen)
    rows = torch.tensor(sizes, dtype=torch.int64, device=dev)
    roff = torch.tensor(np.concatenate([[0], np.cumsum(sizes)[:-1]]),
                        dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for b, hot in ((65536, 1), (65536, 3)):
        div = torch.full((n,), float(hot), device=dev)
        sets = []
        for k in range(8):
            rng = np.random.default_rng(1000 + k)
            sets.append(torch.as_tensor(np.stack(
                [power_law_ids(rng, v, (b, hot)) for v in sizes]).astype(
                    np.int32), device=dev))
        fns = {"tree": lambda i: gather_combine(slab, i, rows, roff, div)}
        for name, lib in libs.items():
            buf = np.zeros(lib.detpu_gather_combine_prepared_bytes(),
                           np.uint8)
            _kernels.check(lib, lib.detpu_gather_combine_prepare(
                slab.data_ptr(), total, 128, 0, rows.data_ptr(),
                roff.data_ptr(), div.data_ptr(), None, None, 0, n, b, hot, 1,
                16,
                buf.ctypes.data), name)
            out = torch.empty((n, b, 128), dtype=torch.bfloat16, device=dev)

            def fn(i, lib=lib, buf=buf, out=out):
                _kernels.check(lib, lib.detpu_gather_combine_launch(
                    buf.ctypes.data, i.data_ptr(), None, out.data_ptr(),
                    stream), "k1 variant")
                return out
            fns[name] = fn
        if len(argv) == 2:
            theirs = parent_gather(argv[1])
            fns["parent"] = lambda i: theirs(slab, i, rows, roff, div)
        want = fns["tree"](sets[0]).clone()
        for name, fn in fns.items():
            if not torch.equal(fn(sets[0]).view(torch.int16),
                               want.view(torch.int16)):
                raise SystemExit(f"k1_variants: {name} differs from K1")
        cur = {}
        got = vs.in_turns(list(fns), lambda name: cur.update(fn=fns[name]),
                          lambda: time_ms(torch, cur["fn"], sets), rounds=3)
        print(f"b={b} hot={hot}: " + ", ".join(
            f"{k} {np.median(v):.4f} ms ({min(v):.4f}-{max(v):.4f})"
            for k, v in got.items()), flush=True)


def time_ms(torch, fn, sets, runs=25, warmup=3):
    """Median CUDA-event ms a call, cycling the id sets."""
    for k in range(warmup):
        fn(sets[k % len(sets)])
    times = []
    for k in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(sets[k % len(sets)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


if __name__ == "__main__":
    main()
