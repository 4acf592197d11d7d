"""Fused bottom-up backward pass: local bounds + thresholds in one sweep.

Counterpart of `ddo_tpu/engine/backward.py`.  The reference computes local
bounds (clean.rs:448-475) and thresholds (clean.rs:478-532) as two
bottom-up traversals over the same out-edges; both are fused into one
reverse sweep.  Every function here takes K lanes at once (a leading K
dimension where ddo_tpu vmaps):

  * `backward_scans` — the plain PyTorch version, a Python loop over
    layers vectorized over lanes and slots;
  * `fused_backward_cuda` — kernel K2 (`csrc/backward.cu`): the layer
    loop inside the kernel, the coming layers' inputs fetched into shared
    memory by the TMA while a layer computes, on the route and with the
    ring, chunk and cluster sizes `backward_plan` chooses;
  * `fused_backward` — K2 for CUDA tensors, `backward_scans` for CPU ones.

All return, for layers 0..n-1: (vb [K, n, W] i32, mk [K, n, W] bool,
th [K, n, W] i32, hs [K, n, W] bool).  Carry encodings: NEG_INF marks an
unmarked local bound, INF "no threshold to propagate".
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ddo_tpu_torch.utils import cuda_build
from ddo_tpu_torch.utils.num import INF, NEG_INF, sat_add, sat_sub

#: K2's routes, in csrc/backward.cu's numbering; each launch counts as
#: "fused_backward.<route>", on "stream" "fused_backward.stream.<CTAs per
#: lane>" (`utils/trace.py`)
ROUTES = ("direct", "tma", "stream")


def thresh_rules(best_known, alive, val, rub, vb, cutf, exact, th, hs):
    """Per-node threshold rules (clean.rs:503-517)."""
    b1 = sat_add(val, rub) <= best_known
    th1 = sat_sub(best_known, rub)
    th2a = torch.minimum(torch.where(hs, th, INF), sat_sub(best_known, vb))
    th2 = torch.where(sat_add(val, vb) <= best_known, th2a, val)
    b3 = exact & ~hs
    new_th = torch.where(b1, th1, torch.where(cutf, th2, torch.where(b3, INF, th)))
    new_hs = hs | b1 | cutf | b3
    return torch.where(alive, new_th, th), torch.where(alive, new_hs, hs)


def _layer_body(best_known, vb_eff, th_eff, ec, eco, ev, val_l, rub_l, cutf_l,
                exact_l, mask_l, ep_l, wlp_l, wlth_l):
    """One fused backward layer for K lanes: edges [K, C], nodes and
    carries [K, W], `best_known` [K, 1]."""
    K, C = ec.shape
    W = vb_eff.shape[1]
    D = C // W
    cc = ec.clamp(0, W - 1).long()
    ok = ev & (ec >= 0)
    g_vb = vb_eff.gather(1, cc)
    g_th = th_eff.gather(1, cc)

    # local bounds (clean.rs:448-475)
    cm = ok & (g_vb > NEG_INF)
    contrib = torch.where(cm, sat_add(g_vb, eco), NEG_INF)
    vb_l = contrib.view(K, W, D).amax(dim=2)
    mk_l = cm.view(K, W, D).any(dim=2)
    new_vb_eff = torch.where(mk_l, vb_l, NEG_INF)

    # thresholds (clean.rs:478-532)
    g_th = torch.where(ok, g_th, INF)
    ch_has = g_th < INF
    cand = torch.where(ch_has, sat_sub(g_th, eco), INF)
    th_l = torch.minimum(cand.view(K, W, D).amin(dim=2), ep_l)
    hs_l = ch_has.view(K, W, D).any(dim=2) | (ep_l < INF)
    th_l = torch.where(hs_l, th_l, INF)
    th_l, hs_l = thresh_rules(best_known, mask_l, val_l, rub_l, vb_l, cutf_l,
                              exact_l, th_l, hs_l)
    use_wl = wlp_l & (wlth_l < INF)
    th_l = torch.where(use_wl, wlth_l, th_l)
    hs_l = hs_l | use_wl
    new_th_eff = torch.where(hs_l & (mask_l | use_wl), th_l, INF)
    return new_vb_eff, new_th_eff, vb_l, mk_l, th_l, hs_l


def _filter_defaults(S_val, ep_theta, wl_pruned, wl_ptheta):
    if ep_theta is None:
        ep_theta = torch.full_like(S_val, INF)
    if wl_pruned is None:
        wl_pruned = torch.zeros(S_val.shape, dtype=torch.bool, device=S_val.device)
        wl_ptheta = torch.full_like(S_val, INF)
    return ep_theta, wl_pruned, wl_ptheta


def backward_scans(E_child, E_cost, E_valid, S_val, S_rub, cutflag, S_exact,
                   S_mask, vb_init, th_init, best_known,
                   ep_theta=None, wl_pruned=None, wl_ptheta=None):
    """Plain PyTorch version: reverse loop over the n layers."""
    ep_theta, wl_pruned, wl_ptheta = _filter_defaults(S_val, ep_theta, wl_pruned,
                                                      wl_ptheta)
    K, n, W = S_val.shape
    bk = best_known.reshape(K, 1)
    vb = torch.empty_like(S_val)
    th = torch.empty_like(S_val)
    mk = torch.empty(S_val.shape, dtype=torch.bool, device=S_val.device)
    hs = torch.empty_like(mk)
    vb_eff, th_eff = vb_init, th_init
    for l in range(n - 1, -1, -1):
        vb_eff, th_eff, vb[:, l], mk[:, l], th[:, l], hs[:, l] = _layer_body(
            bk, vb_eff, th_eff, E_child[:, l], E_cost[:, l], E_valid[:, l],
            S_val[:, l], S_rub[:, l], cutflag[:, l], S_exact[:, l],
            S_mask[:, l], ep_theta[:, l], wl_pruned[:, l], wl_ptheta[:, l],
        )
    return vb, mk, th, hs


#: layers per block of the "tma" route's ring, most first
BLOCK_LAYERS = (16, 8, 4, 2, 1)
#: the "stream" route: ring slots, at least where they fit (fewer, larger
#: chunks cost less per layer) and at most; warps per CTA, at most, and
#: passes over its nodes a warp makes per chunk, at least (chip_smoke.py
#: --sweep-k2 times other values)
STREAM_MIN_DEPTH = 3
STREAM_MAX_DEPTH = 32
STREAM_WARPS = 16
STREAM_PASSES = 2
#: clusters of c CTAs (a power of two up to 16; past 8 a non-portable
#: size) an H100 SXM holds at once at one CTA per SM, as
#: `cudaOccupancyMaxActiveClusters` reports for a "stream" CTA at the most
#: shared memory it takes (chip_smoke.py checks it on the card): lanes
#: past it would wait for a second wave, so the planner keeps K within it
CLUSTERS_RESIDENT = {1: cuda_build.SM_COUNT, 2: 66, 4: 30, 8: 15, 16: 7}
MAX_CLUSTER = max(CLUSTERS_RESIDENT)
#: the "stream" route's node passes a warp keeps in flight at once
#: (csrc/backward.cu's instances of `backward_stream_kernel`)
UNROLLS = (1, 2, 4, 8)


class BackwardPlan(NamedTuple):
    """How K2 sweeps a shape.  `block`: layers per ring block ("tma") or
    node slots per chunk ("stream"); `depth`: ring slots; `cluster`: CTAs
    per lane; `group`: lanes that reduce one node's edges and `unroll`:
    node passes a warp keeps in flight ("stream"); `layout`: a ring
    slot's byte offset of each of the 11 planes, in the order of
    csrc/backward.cu's LayerRows, then the slot's size; `smem`: the shared
    memory of one CTA."""
    route: str
    block: int
    depth: int
    cluster: int
    group: int
    unroll: int
    threads: int
    layout: tuple
    smem: int

    def ints(self):
        """The plan as csrc/backward.cu's `fused_backward` reads it."""
        return [ROUTES.index(self.route), self.block, self.depth, self.cluster,
                self.group, self.unroll, self.threads, *self.layout]


def _plane_bytes(slots, D):
    """Bytes of the 11 input planes for `slots` node slots, LayerRows order."""
    return [4 * slots * D] * 2 + [4 * slots] * 4 + [slots * D] + [slots] * 4


def _layout(rows):
    return tuple(sum(rows[:i]) for i in range(len(rows) + 1))


def _threads(W):
    """A thread per node slot, in whole warps, up to a block."""
    return min(1024, -(-W // 32) * 32)


def _tma_plan(W, D):
    """The most layers per block whose two blocks fit beside the carries."""
    for B in BLOCK_LAYERS:
        layout = _layout([B * r for r in _plane_bytes(W, D)])
        smem = 16 * W + 2 * layout[-1] + 16
        if smem <= cuda_build.SMEM_PER_BLOCK:
            return BackwardPlan("tma", B, 2, 1, 1, 1, _threads(W), layout, smem)
    return None


def _stream_cluster(K, W):
    """The "stream" route's CTAs per lane: the largest cluster size whose
    K clusters the card holds at once (few lanes spread over the card)
    and that leaves each CTA a multiple of 16 node slots."""
    return max(c for c, held in CLUSTERS_RESIDENT.items()
               if c == 1 or (K <= held and W % (16 * c) == 0))


def _ring(W, D, S):
    """(layout, ring slots, shared memory) of chunks of S node slots: as
    many slots as fit beside the carries, up to STREAM_MAX_DEPTH."""
    layout = _layout(_plane_bytes(S, D))
    smem = lambda R: (12 * R + 31) // 16 * 16 + 16 * W + R * layout[-1]
    R = STREAM_MAX_DEPTH
    while R and smem(R) > cuda_build.SMEM_PER_BLOCK:
        R -= 1
    return layout, R, smem(R)


def _stream_plan(W, D, c, unroll=None):
    """Chunks of S node slots, S the largest multiple of 16 dividing the
    CTA's W / c (up to 32 a warp) whose ring holds STREAM_MIN_DEPTH
    chunks, else 16; None when not even two chunks of 16 fit.  A warp
    keeps as many of its node passes in flight as it has, up to 8,
    unless `unroll` says how many."""
    Wc = W // c
    sizes = [S for S in range(16, min(Wc, 32 * STREAM_WARPS) + 1, 16) if Wc % S == 0]
    S = max([S for S in sizes if _ring(W, D, S)[1] >= STREAM_MIN_DEPTH], default=16)
    layout, R, smem = _ring(W, D, S)
    if R < 2:
        return None
    G = min(32, 1 << max(0, D - 1).bit_length())
    # STREAM_PASSES passes of nodes a warp, at least, and a warp's nodes
    # in its lanes
    warps = min(STREAM_WARPS, max(-(-S * G // (32 * STREAM_PASSES)), -(-S // 32)))
    nodes = -(-S // warps)  # a warp's nodes of a chunk
    passes = -(-nodes * G // 32)
    if unroll is None:
        unroll = max(u for u in UNROLLS if u <= passes)
    elif unroll not in UNROLLS:
        raise ValueError(f"fused_backward: no unroll of {unroll}")
    return BackwardPlan("stream", S, R, c, G, unroll, 32 * warps, layout, smem)


def backward_plan(K: int, W: int, D: int, route: str | None = None,
                  cluster: int | None = None, unroll: int | None = None) -> BackwardPlan:
    """K2's route for K lanes of node width W with D out-edges per node.

    A bulk copy needs rows that are 16-byte multiples, so W % 16 != 0
    takes "direct".  Otherwise "tma" where two blocks of one layer fit
    shared memory beside the 16*W bytes of carries (low branching), and
    "stream" where they do not (high branching, very wide layers), or
    "direct" where not even two chunks of 16 node slots fit.  `route`,
    and the "stream" route's `cluster` (CTAs per lane) and `unroll`, force
    a choice, so that a comparison can run several on one shape; a route
    that cannot take the shape raises, as do carries past one block's
    shared memory."""
    carries = 16 * W
    if carries > cuda_build.SMEM_PER_BLOCK:
        raise ValueError(f"fused_backward: W={W} carries exceed the shared memory of "
                         "one block")
    if cluster is not None or unroll is not None:
        if route not in (None, "stream"):
            raise ValueError("fused_backward: only the stream route takes a cluster "
                             "or an unroll")
        route = "stream"
    if cluster is not None:
        if cluster not in [1 << i for i in range(MAX_CLUSTER.bit_length())] \
                or W % (16 * cluster):
            raise ValueError(f"fused_backward: no cluster of {cluster} CTAs at W={W}")
    plans = {"direct": BackwardPlan("direct", 0, 0, 1, 1, 1, _threads(W), (0,) * 12,
                                    carries)}
    if W % 16 == 0:
        plans["tma"] = _tma_plan(W, D)
        plans["stream"] = _stream_plan(W, D, cluster or _stream_cluster(K, W), unroll)
    if route is None:
        route = next(r for r in ("tma", "stream", "direct") if plans.get(r))
    if route not in ROUTES:
        raise ValueError(f"fused_backward: no route {route!r}")
    if not plans.get(route):
        raise ValueError(f"fused_backward: the {route} route does not take W={W}, D={D}")
    return plans[route]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("backward")
    lib.fused_backward.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_void_p]
    lib.fused_backward.restype = ctypes.c_int
    lib.stream_resident_clusters.argtypes = [ctypes.c_int] * 3
    lib.stream_resident_clusters.restype = ctypes.c_int
    return lib


def resident_clusters(c, smem, threads):
    """How many clusters of c "stream" CTAs the card holds at once, as
    `cudaOccupancyMaxActiveClusters` reports (for CLUSTERS_RESIDENT)."""
    held = _lib().stream_resident_clusters(c, smem, threads)
    if held < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with CUDA status {-held}")
    return held


def fused_backward_cuda(E_child, E_cost, E_valid, S_val, S_rub, cutflag,
                        S_exact, S_mask, vb_init, th_init, best_known,
                        ep_theta=None, wl_pruned=None, wl_ptheta=None,
                        route=None, cluster=None, unroll=None):
    """Kernel K2 on CUDA tensors; raises on what the kernel does not take.
    `route`, `cluster` and `unroll` force `backward_plan`'s choice.
    Planes off a 16-byte boundary take "direct", which reads them in
    place."""
    ep_theta, wl_pruned, wl_ptheta = _filter_defaults(S_val, ep_theta, wl_pruned,
                                                      wl_ptheta)
    K, n, W = S_val.shape
    C = E_child.shape[2] if E_child.dim() == 3 else -1
    if C <= 0 or C % W:
        raise ValueError(f"fused_backward: edges must be [K, n, W*D], got "
                         f"{tuple(E_child.shape)} for W={W}")
    i32, b = torch.int32, torch.bool
    spec = [
        ("E_child", E_child, i32, (K, n, C)), ("E_cost", E_cost, i32, (K, n, C)),
        ("E_valid", E_valid, b, (K, n, C)), ("S_val", S_val, i32, (K, n, W)),
        ("S_rub", S_rub, i32, (K, n, W)), ("cutflag", cutflag, b, (K, n, W)),
        ("S_exact", S_exact, b, (K, n, W)), ("S_mask", S_mask, b, (K, n, W)),
        ("ep_theta", ep_theta, i32, (K, n, W)), ("wl_pruned", wl_pruned, b, (K, n, W)),
        ("wl_ptheta", wl_ptheta, i32, (K, n, W)), ("vb_init", vb_init, i32, (K, W)),
        ("th_init", th_init, i32, (K, W)), ("best_known", best_known, i32, (K,)),
    ]
    dev = cuda_build.check_tensors("fused_backward", spec)
    plan = backward_plan(K, W, C // W, route, cluster, unroll)
    if plan.route != "direct" and any(t.data_ptr() % 16 for _, t, _, _ in spec[:11]):
        if route or cluster or unroll:
            raise ValueError(f"fused_backward: the {plan.route} route needs 16-byte "
                             "aligned planes")
        plan = backward_plan(K, W, C // W, "direct")
    vb = torch.empty((K, n, W), dtype=i32, device=dev)
    th = torch.empty_like(vb)
    mk = torch.empty((K, n, W), dtype=torch.uint8, device=dev)
    hs = torch.empty_like(mk)
    if K and n:
        ptrs = (ctypes.c_int64 * 18)(*[t.data_ptr() for _, t, _, _ in spec],
                                     vb.data_ptr(), mk.data_ptr(),
                                     th.data_ptr(), hs.data_ptr())
        ints = plan.ints()
        cluster = f".{plan.cluster}" if plan.route == "stream" else ""
        cuda_build.launch(f"fused_backward.{plan.route}{cluster}", _lib().fused_backward, dev,
                          ptrs, (ctypes.c_int * len(ints))(*ints), K, n, W, C // W)
    return vb, mk.view(torch.bool), th, hs.view(torch.bool)


def fused_backward(E_child, E_cost, E_valid, S_val, S_rub, cutflag, S_exact,
                   S_mask, vb_init, th_init, best_known,
                   ep_theta=None, wl_pruned=None, wl_ptheta=None):
    """Fused local-bounds + thresholds backward pass over K lanes: K2 for
    CUDA tensors, the plain `backward_scans` for CPU ones."""
    args = (E_child, E_cost, E_valid, S_val, S_rub, cutflag, S_exact, S_mask,
            vb_init, th_init, best_known, ep_theta, wl_pruned, wl_ptheta)
    if E_child.is_cuda:
        return fused_backward_cuda(*args)
    if E_child.device.type != "cpu":
        raise ValueError(f"fused_backward: no route for device {E_child.device}")
    return backward_scans(*args)
