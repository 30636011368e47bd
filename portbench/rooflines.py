"""A kernel's share of its roofline in the traced frames or steps: the
least time the card could take for the kernel's calls (`counts/`), from
the cell's shapes and the reference's live-lane counts, over the
kernel's own device time in the trace. None where the trace holds no
call of the kernel (the metric is then left out of the line)."""

from __future__ import annotations

from portbench import trace
from portbench.counts import kernels as K
from portbench.counts.peaks import bound_s

# the device kernels of each hand-written kernel, by name
KERNELS = {
    "b1": ("first_hits_kernel",),
    "b2": ("shade_scatter_kernel",),
    "b3": ("bounce_bwd_kernel", "bounce_bwd_reduce"),
    "b4": ("fold_",),
    "b5": ("traverse_roots", "traverse_walk"),
    "b6": ("shadow_setup", "shadow_walk"),
}


def _calls(ctx, kernel: str):
    """[(bytes, ops)] of the kernel's calls in one traced frame or step."""
    sc, n, spp = ctx["scene"], ctx["lanes"], ctx["spp"]
    bounces = ctx["bounces"]          # per bounce: active, hits, rays, ...
    B = len(bounces)
    L = sc["lights"]
    out = []
    for b, c in enumerate(bounces):
        last = b == B - 1
        use_pair = ctx["route"] == "fused" and sc["atlas"] and (
            not last or L > 0)
        if kernel == "b1":
            out.append(K.b1_first_hits(n, c["active"], int(use_pair),
                                       sc["meshes"], sc["spheres"],
                                       sc["quads"], sc["triangles"]))
        elif kernel == "b2" and ctx["route"] == "fused":
            out.append(K.b2_shade(n, c["active"], c["hits"], use_pair, last,
                                  L, sc["materials"], sc["textured"]))
        elif kernel == "b3" and ctx.get("backward"):
            out.append(K.b3_bounce_bwd(n, c["active"], last, sc["atlas"],
                                       sc["spheres_padded"],
                                       sc["quads_padded"], sc["materials"]))
        elif kernel == "b5" and sc["meshes"]:
            out.append(K.b5_traverse(n, c["active"], sc["nodes"],
                                     sc["triangles"], sc["meshes"],
                                     sc["leaf_width"]))
        elif kernel == "b6" and L:
            out.append(K.b6_shadow(n, c["hits"], L, c["rays"],
                                   c["table_tests"], sc["spheres"],
                                   sc["quads"], sc["nodes"],
                                   sc["triangles"], sc["meshes"],
                                   sc["leaf_width"]))
    if kernel == "b4" and ctx.get("backward") and sc["texels"] > 1:
        n_fold = B if (L or sc["emissive_tex_image"]) else B - 1
        out = [K.b4_fold(n * n_fold, sc["texels"])]
    return out * spp


def share(ctx, kernel: str):
    tr = ctx.get("trace")
    if tr is None:
        return None
    us, count = trace.op_us(tr, KERNELS[kernel])
    calls = _calls(ctx, kernel)
    if count == 0 or not calls or us <= 0:
        return None
    least = sum(bound_s(nb, ops)[0] for nb, ops in calls) * ctx["units"]
    return 100.0 * least / (us * 1e-6)


def bound_by(ctx, kernel: str) -> str:
    """Which bound sets the kernel's roofline over its traced calls."""
    calls = _calls(ctx, kernel)
    byt = sum(bound_s(nb, 0)[0] for nb, _ in calls)
    ops = sum(bound_s(0, o)[0] for _, o in calls)
    return "bytes" if byt >= ops else "operations"
