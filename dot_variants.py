#!/usr/bin/env python3
"""The design choices of K2 and K4 (the DLRM dot interaction's forward and
backward on the tensor cores) timed against each other on one NVIDIA GPU,
and K2's cancellation guard held to the plain version.

Builds variants of ``distributed_embeddings_torch/csrc/dot_interact.cu``
(``variants.py``: patched copies, all ``nvcc`` runs at once): the samples
a tile (the warps a CTA), the persistent CTAs a SM, and K2's guard (a
pair whose Gram entry is below 2^-k of ``|x_i| |x_j|`` is summed again in
fp32, in order: k = 8, 10 (the tree's), 12, or no guard). Checks that the
variants that keep the guard give the tree's bits (a sample's arithmetic
does not depend on the tiling); counts, for the tree's K2 and the guard
variants, the pairs beyond 1 bf16 ulp of the plain version (cuBLAS's
fp32 Gram, rounded once), by how far the pair cancels; then times each
variant with CUDA events, in turns (each variant, then each again in the
reverse order; the median of the two runs' medians), at the DLRM step's
shapes: 27 bf16 features of width 128 as the step passes them (the
bottom-MLP output and 26 views of one embedding buffer), b=65536 (K2 and
K4) and the serving ladder's top rung, 256 (K2).

Run from the root of a checkout: ``python3 dot_variants.py``. Prints the
card's name and power limit, then one line a measurement.
"""

import json
import os
import sys

import numpy as np

import variants as vs

GUARD = "        if (v * v < kGuard * n) again |= 1u << (4 * t + e);"
#: variant -> its patch (None: the tree's source)
VARIANTS = {"base": None,
            "warps8": vs.constants(kTcWarps=8),
            "ctas2": vs.constants(kTcCtas=2),
            "ctas1": vs.constants(kTcCtas=1),
            "guard8": vs.constants(kGuardBits=8),
            "guard12": vs.constants(kGuardBits=12),
            "noguard": vs.replace((GUARD, "        (void)n;"))}
#: the variants whose K2 may differ from the tree's (another guard)
GUARDS = ("guard8", "guard12", "noguard")
#: |G_ij| / (|x_i| |x_j|) bucket edges of the accuracy count
EDGES = (2.0 ** -14, 2.0 ** -12, 2.0 ** -10, 2.0 ** -8)


def beyond_one_ulp(torch, it, feats, names, use):
    """Per variant, K2's pairs beyond 1 bf16 ulp of the plain version on
    ``feats``, by bucket of |G_ij| / (|x_i| |x_j|) (float64); and the
    pairs in each bucket."""
    f = len(feats)
    p = f * (f - 1) // 2
    x = torch.stack(feats, 1).double()
    g = torch.bmm(x, x.transpose(1, 2))
    li, lj = (torch.as_tensor(a, device="cuda")
              for a in np.tril_indices(f, k=-1))
    norm = torch.diagonal(g, dim1=1, dim2=2)
    ratio = (g[:, li, lj].abs() / (norm[:, li] * norm[:, lj]).sqrt()
             ).nan_to_num(0.0)
    bucket = torch.bucketize(ratio, torch.tensor(EDGES, device="cuda",
                                                 dtype=torch.float64))
    want = it.dot_interact_fwd_plain(feats)[:, :p].float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(
        min=2.0 ** -126))) - 7)
    out = {"pairs": torch.bincount(bucket.reshape(-1),
                                   minlength=len(EDGES) + 1).tolist()}
    for name in names:
        use(name)
        got = it.dot_interact_fwd(feats)[:, :p].float()
        bad = (got - want).abs() > ulp
        out[name] = torch.bincount(bucket[bad],
                                   minlength=len(EDGES) + 1).tolist()
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("dot_variants: CUDA is not available")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from distributed_embeddings_torch.ops import _kernels
    from distributed_embeddings_torch.ops import interaction as it

    print(vs.card_line(), flush=True)
    libs = vs.build(_kernels, "dot_interact", VARIANTS, "dot_variants")

    def use(name):
        _kernels._libs["dot_interact"] = libs[name]
        it._FWD.clear()
        it._BWD.clear()

    def turns(fn):
        runs = vs.in_turns(list(VARIANTS), use,
                           lambda: cs.time_ms(torch, fn, [()]))
        return {n: round(float(np.median(v)), 4) for n, v in runs.items()}

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    # the card tests' inputs (test_dot_interact_kernel_matches_plain)
    for b in (257, 65536):
        x = torch.randn((b, 27, 128), generator=torch.Generator()
                        .manual_seed(3)).to(torch.bfloat16).cuda()
        print(f"K2 beyond 1 bf16 ulp, the card test's b={b}, by |G_ij| / "
              f"(|x_i| |x_j|) < {EDGES} and above: " + json.dumps(
                  beyond_one_ulp(torch, it, list(x.unbind(1)),
                                 ("base",) + GUARDS, use)), flush=True)
        del x
    for b in (cs.TRAIN_BATCH, cs.RUNG):
        sets = [cs.step_features(torch, gen, b) for _ in range(4)]
        dys = [torch.randn((b, 27 * 26 // 2 + 128), generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(4)]
        ref = None
        for name in VARIANTS:
            use(name)
            got = (it.dot_interact_fwd(sets[0]),
                   torch.stack(it.dot_interact_bwd(sets[0], dys[0])))
            torch.cuda.synchronize()
            ref = got if ref is None else ref
            same = [torch.equal(x.view(torch.int16), y.view(torch.int16))
                    for x, y in zip(got, ref)]
            if not same[1] or not (same[0] or name in GUARDS):
                raise SystemExit(f"dot_variants: {name} differs from base "
                                 f"at b={b}")
        if b == cs.TRAIN_BATCH:
            for k, fs in enumerate(sets):
                print(f"K2 beyond 1 bf16 ulp, the step's features, set {k}: "
                      + json.dumps(beyond_one_ulp(
                          torch, it, fs, ("base",) + GUARDS, use)),
                      flush=True)
        k2 = cs.cycling(it.dot_interact_fwd, [(s,) for s in sets])
        print(f"K2, b={b} (ms): " + json.dumps(turns(k2)), flush=True)
        if b == cs.TRAIN_BATCH:
            k4 = cs.cycling(it.dot_interact_bwd, list(zip(sets, dys)))
            print(f"K4, b={b} (ms): " + json.dumps(turns(k4)), flush=True)
        del sets, dys, ref, got
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
