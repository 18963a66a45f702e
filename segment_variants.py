#!/usr/bin/env python3
"""The design choices of K3's and K18's engine timed against each other on
one NVIDIA GPU.

Builds variants of ``distributed_embeddings_torch/csrc/segment_scatter.cuh``
(``variants.py``; the constants a variant changes: K18's ring stages and columns a block,
the segment length from which K18 takes the block path, the update rows a
lane loads ahead, K3's chunk L) by patching a copy of the sources, each
with ``nvcc`` into ``build/segment_variants/``, all builds at once;
checks that every variant gives the tree's bits (but the chunk-length
ones, which split other rows); then times each with CUDA events, in turns
(each variant, then each again in the reverse order; the median of the
two runs' medians):

* K18 at the DLRM example's stream (26 x 65536 Zipfian ids into the
  capped Criteo-Kaggle bf16 slab, width 128, lr 24), and that stream's
  hottest row alone (its serial chain);
* K3 at the same stream (constant lr), at the multi-hot ragged DLRM's
  stream (26 features of U{1..30} power-law ids a row, b=65536, padding
  positions at the dropped-row sentinel, into the fp32 slab, bf16 rows)
  and as the tiny zoo's w8 scatter-sum (the w8 stream of one b=65536
  batch of the uncapped zoo, into a zero fp32 gradient slab, lr -1).

Run from the root of a checkout: ``python3 segment_variants.py``. Prints
the card's name and power limit, then one line a shape.
"""

import json
import sys

import numpy as np

import variants as vs

#: library -> variant -> the constants it sets
VARIANTS = {
    "sgd_promoted": {"base": {}, "ring4": {"kStages": "4"},
                     "cols16": {"kBlockCols": "16"},
                     "long128": {"kLongClass": "7"},
                     "long512": {"kLongClass": "9"}},
    "sgd_scatter": {"base": {}, "batch2": {"kBatch": "2"},
                    "batch8": {"kBatch": "8"}, "split64": {"kSplit": "64"},
                    "split1024": {"kSplit": "1024"}}}


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("segment_variants: CUDA is not available")
    sys.path.insert(0, vs.HERE)
    import chip_smoke as cs
    from distributed_embeddings_torch.ops import _kernels
    from distributed_embeddings_torch.ops import scatter_add as sa

    print(vs.card_line(), flush=True)
    libs = {(lib, name): handle for lib, variants in VARIANTS.items()
            for name, handle in vs.build(
                _kernels, lib, {n: vs.constants(**c) if c else None
                                for n, c in variants.items()},
                "segment_variants", "segment_scatter.cuh").items()}

    def use(lib, name):
        handle = libs[(lib, name)]
        _kernels._libs[lib] = handle
        if lib == "sgd_promoted":
            sa.LONG_SEGMENT = int(handle.detpu_segment_long())
        else:
            sa.SPLIT = int(handle.detpu_segment_split())
        sa._K3.clear()
        sa._K18.clear()

    def same_bits(lib, fn, slab):
        ref, out = None, {}
        for name, patch in VARIANTS[lib].items():
            if "kSplit" in patch:
                continue
            use(lib, name)
            s = slab.clone()
            fn(s)
            torch.cuda.synchronize()
            ref = s if ref is None else ref
            out[name] = bool(torch.equal(s.view(torch.int16),
                                         ref.view(torch.int16)))
        if not all(out.values()):
            raise SystemExit(f"segment_variants: {lib} variants differ: "
                             f"{out}")

    def turns(lib, fn):
        runs = vs.in_turns(list(VARIANTS[lib]), lambda n: use(lib, n),
                           lambda: cs.time_ms(torch, fn, [()]))
        return {n: round(float(np.median(v)), 4) for n, v in runs.items()}

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    sizes = cs.ragged_sizes()
    offs = np.cumsum([0] + sizes[:-1])
    rows = sum(sizes)
    roff = torch.as_tensor(offs, dtype=torch.int32, device="cuda")
    # the example's stream
    slab = torch.randn((rows, 128), generator=gen, device="cuda").to(
        torch.bfloat16)
    args = []
    for k in range(4):
        cats, _ = cs.train_batch(torch, sizes, cs.TRAIN_BATCH,
                                 seed=cs.SEED + 220 + k)
        ids = (torch.stack(cats, 1) + roff).reshape(-1).contiguous()
        vals = (torch.randn((ids.numel(), 128), generator=gen, device="cuda")
                * 1e-3).to(torch.bfloat16)
        args.append((ids, vals))
    lr = torch.tensor(cs.PROMOTED_SCHEDULE[0], device="cuda")
    same_bits("sgd_promoted",
              lambda s: sa.sgd_scatter_promoted(s, *args[0], lr), slab)
    k18 = cs.cycling(lambda i, v: sa.sgd_scatter_promoted(slab, i, v, lr),
                     args)
    print("K18, the example's stream (ms): "
          + json.dumps(turns("sgd_promoted", k18)), flush=True)
    ids0, vals0 = args[0]
    uniq, counts = torch.unique(ids0, return_counts=True)
    hot = ids0 == uniq[counts.argmax()]
    hot_ids, hot_vals = ids0[hot].contiguous(), vals0[hot].contiguous()
    print(f"K18, the hottest row's {int(counts.max())} entries alone (ms): "
          + json.dumps(turns("sgd_promoted", lambda: sa.sgd_scatter_promoted(
              slab, hot_ids, hot_vals, lr))), flush=True)
    k3 = cs.cycling(lambda i, v: sa.sgd_scatter(
        slab, i, v, cs.PROMOTED_SCHEDULE[0]), args)
    print("K3, the example's stream (ms): "
          + json.dumps(turns("sgd_scatter", k3)), flush=True)
    del slab, args, k18, k3
    torch.cuda.empty_cache()
    # the ragged stream: padding positions at the sentinel
    nnz = [int(torch.randint(1, 2 * cs.RAGGED_HOT + 1, (cs.TRAIN_BATCH,),
                             generator=gen, device="cuda").sum())
           for _ in sizes]
    cap = max(nnz)
    parts = []
    for t, v in enumerate(sizes):
        part = torch.full((cap,), rows, dtype=torch.int32, device="cuda")
        part[:nnz[t]] = cs.device_power_law(torch, gen, v, nnz[t]) + int(
            offs[t])
        parts.append(part)
    ids = torch.cat(parts)
    del parts
    vals = (torch.randn((ids.numel(), 128), generator=gen, device="cuda")
            * 1e-3).to(torch.bfloat16)
    slab = torch.randn((rows, 128), generator=gen, device="cuda")
    same_bits("sgd_scatter",
              lambda s: sa.sgd_scatter(s, ids, vals, cs.TRAIN_LR), slab)
    print(f"K3, the ragged stream of {ids.numel()} positions (ms): "
          + json.dumps(turns("sgd_scatter", lambda: sa.sgd_scatter(
              slab, ids, vals, cs.TRAIN_LR))), flush=True)
    del slab, ids, vals
    torch.cuda.empty_cache()
    # the zoo's w8 scatter-sum: the w8 stream of one batch of the step
    from distributed_embeddings_torch.models import InputGenerator
    from distributed_embeddings_torch.parallel import apply

    cfg, de, _, st = cs.zoo_model(torch, torch.float32)
    _, cats, _ = InputGenerator(cfg, cs.ZOO_BATCH, alpha=1.05,
                                num_batches=1, seed=0, device="cuda")[0]
    with torch.no_grad():
        outs, res = de.forward_with_residuals(st.emb_params, cats)
    tris = apply.cotangent_width_streams(
        de, res, [torch.randn_like(o) for o in outs])["w8"]
    ids = torch.cat([t[0].reshape(-1) for t in tris]).contiguous()
    vals = torch.cat([t[1].reshape(-1, 8) for t in tris]).float()
    gz = torch.zeros(tuple(st.emb_params["w8"].shape[1:]), device="cuda")
    del de, st, outs, res, tris
    print(f"K3, the zoo's w8 scatter-sum of {ids.numel()} ids (ms): "
          + json.dumps(turns("sgd_scatter", lambda: sa.sgd_scatter(
              gz.zero_(), ids, vals, -1.0))), flush=True)


if __name__ == "__main__":
    main()
