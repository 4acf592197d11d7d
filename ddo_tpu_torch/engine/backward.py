"""Fused bottom-up backward pass: local bounds + thresholds in one sweep.

Counterpart of `ddo_tpu/engine/backward.py`.  The reference computes local
bounds (clean.rs:448-475) and thresholds (clean.rs:478-532) as two
bottom-up traversals over the same out-edges; both are fused into one
reverse sweep.  Every function here takes K lanes at once (a leading K
dimension where ddo_tpu vmaps):

  * `backward_scans` — the plain PyTorch version, a Python loop over
    layers vectorized over lanes and slots;
  * `fused_backward_cuda` — kernel K2 (`csrc/backward.cu`): one CTA per
    lane with the layer loop inside the kernel, the next block of layers'
    inputs fetched into shared memory by the TMA while a block computes
    (`backward_plan` sizes the blocks);
  * `fused_backward` — K2 for CUDA tensors, `backward_scans` for CPU ones.

All return, for layers 0..n-1: (vb [K, n, W] i32, mk [K, n, W] bool,
th [K, n, W] i32, hs [K, n, W] bool).  Carry encodings: NEG_INF marks an
unmarked local bound, INF "no threshold to propagate".
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ddo_tpu_torch.utils import cuda_build
from ddo_tpu_torch.utils.num import INF, NEG_INF, sat_add, sat_sub

#: launches of kernel K2 since import
KERNEL_LAUNCHES = 0


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


#: layers per block of K2's ring, most first
BLOCK_LAYERS = (16, 8, 4, 2, 1)


def backward_plan(W: int, D: int):
    """K2's route for node width W and D out-edges per node: (B, layout).

    B is the most layers per block (BLOCK_LAYERS) for which two blocks of
    the 11 input planes fit one block's shared memory beside the 16*W
    bytes of carries, when every row is a multiple of 16 bytes (W % 16 ==
    0) so the TMA can copy it; else 0, the direct route.  `layout` is a
    ring slot's byte offset of each plane's B rows, in the order of
    csrc/backward.cu's LayerRows, then the slot's size.  Raises when the
    carries alone exceed shared memory."""
    carries = 16 * W
    if carries > cuda_build.SMEM_PER_BLOCK:
        raise ValueError(f"fused_backward: W={W} carries exceed the shared memory of "
                         "one block")
    if W % 16 == 0:
        C = W * D
        rows = [4 * C, 4 * C] + [4 * W] * 4 + [C] + [W] * 4
        for B in BLOCK_LAYERS:
            layout = [B * sum(rows[:i]) for i in range(len(rows) + 1)]
            if carries + 2 * layout[-1] + 16 <= cuda_build.SMEM_PER_BLOCK:
                return B, layout
    return 0, [0] * 12


@functools.lru_cache(maxsize=None)
def _lib():
    lib = cuda_build.load("backward")
    lib.fused_backward.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p]
    lib.fused_backward.restype = ctypes.c_int
    return lib


def fused_backward_cuda(E_child, E_cost, E_valid, S_val, S_rub, cutflag,
                        S_exact, S_mask, vb_init, th_init, best_known,
                        ep_theta=None, wl_pruned=None, wl_ptheta=None):
    """Kernel K2 on CUDA tensors; raises on what the kernel does not take."""
    global KERNEL_LAUNCHES
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
    dev = E_child.device
    for name, t, dtype, shape in spec:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"fused_backward: {name} is not on {dev}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"fused_backward: {name} must be {dtype} {list(shape)}, "
                             f"got {t.dtype} {list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"fused_backward: {name} must be contiguous")
    vb = torch.empty((K, n, W), dtype=i32, device=dev)
    th = torch.empty_like(vb)
    mk = torch.empty((K, n, W), dtype=torch.uint8, device=dev)
    hs = torch.empty_like(mk)
    block, layout = backward_plan(W, C // W)
    if block and any(t.data_ptr() % 16 for _, t, _, _ in spec[:11]):
        block = 0  # a bulk copy needs 16-byte aligned planes
    if K and n:
        ptrs = (ctypes.c_int64 * 18)(*[t.data_ptr() for _, t, _, _ in spec],
                                     vb.data_ptr(), mk.data_ptr(),
                                     th.data_ptr(), hs.data_ptr())
        ring = (ctypes.c_int * len(layout))(*layout)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            status = _lib().fused_backward(ptrs, ring, block, K, n, W, C // W, stream)
        cuda_build.check(status, "fused_backward")
        KERNEL_LAUNCHES += 1
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
