// K3: the tail of the compile's layer body (ddo_tpu_torch/engine/layer_tail.py).
//
// Replaces no `pl.pallas_call`: it fuses plain tensor operations of
// ddo_tpu/engine/mdd.py's `forward_step` (mdd.py:637-895), which the port
// ran as some 240 small PyTorch kernels a layer in `_Layers._seg3`
// (engine/mdd.py), the same for every model: sort-2's order turned into
// kept, merged and pruned nodes, the edge remap, the merged node's
// aggregates, the next layer's materialization and within-layer
// dominance, and the writes of layer i's planes.  Three kernels, cut
// where the model's hooks run between them as PyTorch calls (`merge`,
// `pack`, `relax_cost`; `take_rows`, the dominance columns):
//
//   remap_kernel (K3a)      the survivors' ranks, kept / merged codes, each
//                           run head's code and theta carried down its run
//                           and scattered back to candidate order;
//   edges_kernel (K3b)      recycling, every edge of layer i, the merged
//                           node's best in-edge, layer i's planes, the next
//                           layer with the merged node's overrides, lel,
//                           overflow;
//   dominance_kernel (K3c)  the next layer's within-layer dominance and the
//                           carried layer; advances the layer index.
//
// K3b writes layer i's planes because every one of its CTAs reads the
// layer index i; K3c reads none, so its first CTA advances i with no race.
//
// What bounds it: a layer's bytes are a few [K, W*D] int32 planes read or
// written once (kp: 1 x 512 candidates, ~20 KB), microseconds at 3.35
// TB/s; the work is a handful of integer operations a candidate, and a
// W x W comparison a lane for dominance.  So what the eager body paid was
// its kernel count, ~1.7 us a kernel back to back in a graph, and what
// bounds K3 is its own latency: three launches, and inside each a chain of
// dependent passes over one lane with block-wide barriers between them.
// The design keeps that chain short: one CTA per lane, every per-lane
// reduction (the forward fill, the merged node's best edge, recycling) a
// warp-shuffle scan or reduction with two barriers, each lane's W-sized
// arrays (per-parent minima and flags) in shared memory, and each
// candidate handled by one thread in every pass that reads it, so that a
// thread reads back only what it wrote itself.  Within-layer dominance
// spreads each node's W comparisons over up to 32 threads.  All shapes
// of the engine run here: C = W*D from 16 to ~10^5 rows walked in tiles
// of up to 1,024 threads, any K, any W that shared memory holds (12 W
// bytes, up to W = 19,370; K2 takes W up to 14,528).
//
// Semantics are the torch body's bit for bit: saturating int32 adds and
// subtractions, argmax's first index for the recycled slot, the largest
// flat index among the merged node's best in-edges, the recycled-merge
// divergence (engine/mdd.py's module notes).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define INF_ 1073741823  // (1 << 30) - 1, utils/num.py
#define NEG_INF_ (-INF_)
#define M27_ ((1 << 27) - 1)
#define FULL_ 0xffffffffu

typedef uint8_t u8;

__device__ __forceinline__ int sat_add(int a, int b) {
  // the int32 sum wraps as torch's does, then clamps
  const int s = (int)((unsigned)a + (unsigned)b);
  return min(max(s, NEG_INF_), INF_);
}

__device__ __forceinline__ int sat_sub(int a, int b) {
  const int s = (int)((unsigned)a - (unsigned)b);
  return min(max(s, NEG_INF_), INF_);
}

// The rank below which a survivor is kept (layer_tail.py `_limit`).
__device__ __forceinline__ int keep_limit(int cap, bool relax, bool restrict_, int C) {
  return relax ? cap - 1 : (restrict_ ? cap : C);
}

// Inclusive max-scan of `v` over the CTA (blockDim.x a multiple of 32);
// `*total` gets the CTA's maximum.  `sm`: 32 ints of shared memory.
__device__ int block_scan_max(int v, int* sm, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL_, v, d);
    if (lane >= d) v = max(v, u);
  }
  __syncthreads();  // sm is free from its last use
  if (lane == 31) sm[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nw ? sm[lane] : INT_MIN;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(FULL_, w, d);
      if (lane >= d) w = max(w, u);
    }
    sm[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = max(v, sm[warp - 1]);
  *total = sm[nw - 1];
  return v;
}

__device__ int block_min(int v, int* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int d = 16; d; d >>= 1) v = min(v, __shfl_xor_sync(FULL_, v, d));
  __syncthreads();
  if (lane == 0) sm[warp] = v;
  __syncthreads();
  int r = sm[0];
  for (int w = 1; w < nw; ++w) r = min(r, sm[w]);
  return r;
}

__device__ long long block_max_ll(long long v, long long* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int d = 16; d; d >>= 1) v = max(v, __shfl_xor_sync(FULL_, v, d));
  __syncthreads();
  if (lane == 0) sm[warp] = v;
  __syncthreads();
  long long r = sm[0];
  for (int w = 1; w < nw; ++w) r = max(r, sm[w]);
  return r;
}

// ------------------------------------------------------------------ K3a
struct RemapArgs {
  const int* neg_order;  // [K, C] sort-2's last operand: -(sort-1 position)
  const u8* surv;        // [K, C] sort-1 order
  const u8* head;
  const int* perm;       // sort-1 position -> candidate
  const u8* pruned;
  const u8* pci;
  const int* ptheta;
  const int* cap;        // [K]
  const u8* need_relax;
  const u8* need_restrict;
  int* rank_of;          // [K, C] sort-1 order
  u8* kept;
  int* e_code;           // [K, C] candidate order
  int* cand_ptheta;
  u8* f_mmask;
  int C;
};

__global__ void remap_kernel(RemapArgs a) {
  __shared__ int sm[32];
  const int k = blockIdx.x, C = a.C, T = blockDim.x, tid = threadIdx.x;
  const size_t o = (size_t)k * C;
  const int *neg_order = a.neg_order + o, *perm = a.perm + o, *ptheta = a.ptheta + o;
  const u8 *surv = a.surv + o, *head = a.head + o, *pruned = a.pruned + o, *pci = a.pci + o;
  int* rank_of = a.rank_of + o;
  const bool relax = a.need_relax[k];
  const int limit = keep_limit(a.cap[k], relax, a.need_restrict[k], C);
  for (int j = tid; j < C; j += T) rank_of[-neg_order[j]] = j;
  __syncthreads();
  // the forward fill: each position takes the code of the last run head
  // at or before it (position 0's where none), carried across tiles
  int carry = -1;
  for (int j0 = 0; j0 < C; j0 += T) {
    const int j = j0 + tid;
    int total;
    const int h = max(block_scan_max(j < C && head[j] ? j : -1, sm, &total), carry);
    carry = max(carry, total);
    if (j < C) {
      const int p = max(h, 0), rp = rank_of[p];
      const bool kp = surv[p] && rp < limit, mp = surv[p] && !kp && relax;
      const int code = rp + ((int)kp << 27) + ((int)mp << 28) + ((int)(pruned[p] != 0) << 29) +
                       ((int)(pci[p] != 0) << 30);
      const bool kj = surv[j] && rank_of[j] < limit;
      const size_t dst = o + perm[j];
      a.e_code[dst] = code;
      a.cand_ptheta[dst] = ptheta[p];
      a.f_mmask[dst] = surv[j] && !kj && relax;
      a.kept[o + j] = kj;
    }
  }
}

// ------------------------------------------------------------------ K3b
struct EdgesArgs {
  const long long* i;  // the layer index
  // [K, C] (kv [K, C, Kk]; cap, U, need_* [K])
  const int *neg_order, *so_key, *so_negval, *kv, *cap, *U;
  const u8 *need_relax, *need_restrict;
  const int *perm, *val_s;
  const u8 *slot_exact, *skip_s;  // skip_s: null without long arcs
  const u8* f_valid;
  const int *f_cost, *f_dval;
  const u8* f_skip;
  const int* rank_of;  // remap's
  const u8* kept;
  const int *e_code, *cand_ptheta;
  const int* merged_key;  // [K, Kk]
  const int* rcost;       // [K, C], null unless relaxed
  // layer i's own rows [K, W], in NODE_PLANES order
  const int* l_val;
  const u8 *l_mask, *l_exact, *l_relaxed;
  const int *l_rub, *l_bp, *l_bd;
  const u8 *l_bs, *l_wlp;
  const int* l_wlth;
  // layer planes [K, n+1, W], the same order
  int* p_val;
  u8 *p_mask, *p_exact, *p_relaxed;
  int *p_rub, *p_bp, *p_bd;
  u8 *p_bs, *p_wlp;
  int* p_wlth;
  u8* hic;       // [K, n, W]
  int* eptheta;  // [K, n, W], null without filtering
  int* e_child;  // [K, n, C]
  int* e_cost;
  u8* e_valid;
  int* lel;  // [K]
  u8* overflow;
  // the next layer [K, W] (layer_tail.py `Next`)
  int* fidx;
  u8* q_valid;
  int* nl_val;
  u8 *nl_exact, *nl_relaxed;
  int *nl_bp, *nl_bd;
  u8 *nl_bs, *fresh;
  int C, W, n, Kk;
};

__global__ void edges_kernel(EdgesArgs a) {
  extern __shared__ int smem[];  // epmin[W], hic[W], exact[W]
  __shared__ long long red[32];
  const int C = a.C, W = a.W, D = C / W, n = a.n, Kk = a.Kk;
  const int k = blockIdx.x, T = blockDim.x, tid = threadIdx.x;
  int *epmin = smem, *hic_s = smem + W, *exact_s = smem + 2 * W;
  const long long li = *a.i;
  const size_t oc = (size_t)k * C, ow = (size_t)k * W;
  const size_t oe = ((size_t)k * n + li) * C, oh = ((size_t)k * n + li) * W;
  const size_t op = ((size_t)k * (n + 1) + li) * W;
  const bool relax = a.need_relax[k], restrict_ = a.need_restrict[k];
  const bool squashed = relax || restrict_, long_arcs = a.skip_s != nullptr;
  const int cap = a.cap[k], U = a.U[k], limit = keep_limit(cap, relax, restrict_, C);
  for (int w = tid; w < W; w += T) {
    epmin[w] = INF_;
    hic_s[w] = 0;
  }

  // 1. the merged node recycles the first kept survivor of its own key
  int first = C;
  if (relax) {
    const int* mk = a.merged_key + (size_t)k * Kk;
    for (int j = tid; j < C; j += T) {
      if (!a.kept[oc + j] || j >= first) continue;
      const int* key = a.kv + (oc + j) * Kk;
      bool eq = true;
      for (int x = 0; x < Kk && eq; ++x) eq = key[x] == mk[x];
      if (eq) first = j;
    }
  }
  first = block_min(first, (int*)red);
  const bool recycled = relax && first < C;
  const int rslot = first < C ? first : 0;
  const int merged_pos = recycled ? a.rank_of[oc + rslot] : limit;

  // 2. every edge of layer i, in candidate order; the merged node's best
  // in-edge as the largest (value, index)
  long long best = LLONG_MIN;
  for (int c = tid; c < C; c += T) {
    const int code = a.e_code[oc + c], f_cost = a.f_cost[oc + c];
    const bool fv = a.f_valid[oc + c];
    const bool saved = recycled && (code & M27_) == limit && (code & (1 << 28));
    const bool kept = fv && ((code & (1 << 27)) || saved);
    const bool merge = fv && (code & (1 << 28)) && relax && !saved;
    const int cost = (a.rcost && merge) ? a.rcost[oc + c] : f_cost;
    const int child = kept ? (code & M27_) : (merge ? merged_pos : -1);
    a.e_child[oe + c] = child;
    a.e_cost[oe + c] = cost;
    a.e_valid[oe + c] = fv && child >= 0;
    if (a.eptheta && fv && (code & (1 << 29)))
      atomicMin(epmin + c / D, sat_sub(a.cand_ptheta[oc + c], f_cost));
    if (merge)
      best = max(best, (long long)sat_add(a.l_val[ow + c / D], cost) * 4294967296LL + c);
  }
  best = block_max_ll(best, red);  // its barriers also end step 2's atomics
  const bool has_m = best != LLONG_MIN;
  const int m_val = has_m ? (int)(best >> 32) : NEG_INF_;
  const int m_best = has_m ? (int)(best & 0xffffffffLL) : 0;
  const int m_bp = has_m ? m_best / D : -1;
  const int m_bd = has_m ? a.f_dval[oc + m_best] : 0;
  const bool m_bs = has_m && long_arcs && a.f_skip[oc + m_best];
  const bool take_m = has_m && (!recycled || m_val >= a.val_s[oc + rslot]);
  const int width_used = squashed ? (relax ? limit + 1 : cap) : min(U, W);

  // 3. the next layer: sort-2's first W slots through both permutations,
  // with the merged node's overrides
  for (int q = tid; q < W; q += T) {
    const int j = -a.neg_order[oc + q];
    const int f = a.perm[oc + j];
    const bool sv = a.so_key[oc + q] == 0, mpos = relax && q == merged_pos;
    int val = -a.so_negval[oc + q];
    int bp = sv ? f / D : -1, bd = a.f_dval[oc + f];
    bool bs = long_arcs && a.skip_s[oc + j];
    if (mpos) {
      val = recycled ? max(val, m_val) : m_val;
      if (take_m) {
        bp = m_bp;
        bd = m_bd;
        if (long_arcs) bs = m_bs;
      }
    }
    const bool qv = (q < width_used && sv) || mpos;
    const bool ex = a.slot_exact[oc + j] && !mpos && qv;
    a.fidx[ow + q] = f;
    a.q_valid[ow + q] = qv;
    a.nl_val[ow + q] = val;
    a.nl_exact[ow + q] = ex;
    a.nl_relaxed[ow + q] = mpos;  // mpos implies qv
    a.nl_bp[ow + q] = bp;
    a.nl_bd[ow + q] = bd;
    a.nl_bs[ow + q] = bs;
    a.fresh[ow + q] = mpos && !recycled;
    exact_s[q] = ex;
    if (a.eptheta) a.eptheta[oh + q] = epmin[q];
  }
  __syncthreads();

  // 4. a parent has an inexact child (or a cache-pruned inexact one): each
  // thread reads back only the edges it wrote in step 2
  for (int c = tid; c < C; c += T) {
    const int child = a.e_child[oe + c];
    const bool pci = a.f_valid[oc + c] && (a.e_code[oc + c] & (1 << 30));
    if (pci || (a.e_valid[oe + c] && !exact_s[min(max(child, 0), W - 1)])) hic_s[c / D] = 1;
  }
  __syncthreads();

  // 5. layer i's node planes
  for (int w = tid; w < W; w += T) {
    a.p_val[op + w] = a.l_val[ow + w];
    a.p_mask[op + w] = a.l_mask[ow + w];
    a.p_exact[op + w] = a.l_exact[ow + w];
    a.p_relaxed[op + w] = a.l_relaxed[ow + w];
    a.p_rub[op + w] = a.l_rub[ow + w];
    a.p_bp[op + w] = a.l_bp[ow + w];
    a.p_bd[op + w] = a.l_bd[ow + w];
    a.p_bs[op + w] = a.l_bs[ow + w];
    a.p_wlp[op + w] = a.l_wlp[ow + w];
    a.p_wlth[op + w] = a.l_wlth[ow + w];
    a.hic[oh + w] = hic_s[w];
  }
  if (tid == 0) {
    if (U > W && !squashed) a.overflow[k] = 1;
    if (squashed && a.lel[k] == n + 1) a.lel[k] = (int)li;
  }
}

// ------------------------------------------------------------------ K3c
struct DomArgs {
  long long* i;
  // the next layer [K, W] (layer_tail.py `Next`; fidx and fresh unread)
  const int* fidx;
  const u8* q_valid;
  const int* nl_val;
  const u8 *nl_exact, *nl_relaxed;
  const int *nl_bp, *nl_bd;
  const u8 *nl_bs, *fresh;
  const int* dkey;    // [K, W, KK]
  const int* dcoord;  // [K, W, CC]
  const u8* c_ebp;    // [K, W] the layer's own ebp
  // the carried layer [K, W], in CARRY order
  int* val;
  u8 *mask, *exact, *relaxed;
  int *bp, *bd;
  u8 *bs, *ebp, *wlp;
  int* wlth;
  int W, KK, CC, use_value, wl, split;
};

// Whether node i strictly dominates node j of one lane (both candidates:
// valid and exact); `*eq` whether their coordinates are equal.
__device__ __forceinline__ bool dominates(const DomArgs& a, const int* key, const int* crd,
                                          const int* val, int i, int j, bool* eq) {
  for (int x = 0; x < a.KK; ++x)
    if (key[i * a.KK + x] != key[j * a.KK + x]) return false;
  bool e = true;
  for (int x = 0; x < a.CC; ++x) {
    const int ci = crd[i * a.CC + x], cj = crd[j * a.CC + x];
    if (ci < cj) return false;
    e = e && ci == cj;
  }
  *eq = e;
  if (a.use_value) return val[i] >= val[j] && !(e && val[i] == val[j]);
  return !e;
}

__global__ void dominance_kernel(DomArgs a) {
  extern __shared__ int smem[];  // pruned[W], threshold[W]
  const int W = a.W, S = a.split, k = blockIdx.x, T = blockDim.x, tid = threadIdx.x;
  int *pr_s = smem, *th_s = smem + W;
  const size_t ow = (size_t)k * W;
  const u8 *qv = a.q_valid + ow, *ex = a.nl_exact + ow;
  const int* val = a.nl_val + ow;
  if (a.wl) {
    const int *key = a.dkey + ow * a.KK, *crd = a.dcoord + ow * a.CC;
    // S threads a node j, each over every S-th node i; groups of S lanes
    // are aligned within a warp
    const int part = tid % S;
    for (int j0 = 0; j0 < W; j0 += T / S) {
      const int j = j0 + tid / S;
      bool pr = false;
      if (j < W && qv[j] && ex[j]) {
        for (int i = part; i < W && !pr; i += S) {
          bool eq;
          pr = qv[i] && ex[i] && dominates(a, key, crd, val, i, j, &eq);
        }
      }
      for (int d = 1; d < S; d <<= 1) pr = __shfl_xor_sync(FULL_, (int)pr, d) | (int)pr;
      if (j < W && part == 0) pr_s[j] = pr;
    }
    __syncthreads();
    // thresholds from maximal dominators only
    for (int j0 = 0; j0 < W; j0 += T / S) {
      const int j = j0 + tid / S;
      int th = INF_;
      if (a.use_value && j < W && pr_s[j]) {
        for (int i = part; i < W; i += S) {
          bool eq;
          if (qv[i] && ex[i] && !pr_s[i] && dominates(a, key, crd, val, i, j, &eq))
            th = min(th, eq ? val[i] - 1 : val[i]);
        }
      }
      for (int d = 1; d < S; d <<= 1) th = min(th, __shfl_xor_sync(FULL_, th, d));
      if (j < W && part == 0) th_s[j] = th;
    }
    __syncthreads();
  }
  for (int w = tid; w < W; w += T) {
    const bool pr = a.wl && pr_s[w];
    const bool v = qv[w] && !pr, e = ex[w] && v, r = a.nl_relaxed[ow + w] && v;
    const int bp = a.nl_bp[ow + w];
    const bool par = bp >= 0 && a.c_ebp[ow + min(max(bp, 0), W - 1)];
    a.val[ow + w] = v ? val[w] : NEG_INF_;
    a.mask[ow + w] = v;
    a.exact[ow + w] = e;
    a.relaxed[ow + w] = r;
    a.bp[ow + w] = bp;
    a.bd[ow + w] = a.nl_bd[ow + w];
    a.bs[ow + w] = a.nl_bs[ow + w] && v;
    a.ebp[ow + w] = (e || (!r && par)) && v;
    a.wlp[ow + w] = pr;
    a.wlth[ow + w] = pr ? th_s[w] : INF_;
  }
  if (k == 0 && tid == 0) *a.i += 1;
}

// ---------------------------------------------------------------- entry points
static cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Threads of a CTA that walks `rows` rows: whole warps, up to 1,024.
static int threads_for(long long rows) {
  const long long t = (rows + 31) / 32 * 32;
  return (int)(t < 32 ? 32 : (t > 1024 ? 1024 : t));
}

template <class T>
static T ptr(const int64_t* p, int j) {
  return reinterpret_cast<T>(p[j]);
}

// `ptrs`: a host array of device pointers in layer_tail.py's order
// (`remap_cuda`, `edges_cuda`, `dominance_cuda`); `ints` their sizes and
// flags.  Each returns 0 or a CUDA error code.
extern "C" int layer_tail_remap(const int64_t* p, const int* ints, void* stream) {
  RemapArgs a;
  a.neg_order = ptr<const int*>(p, 0);
  a.surv = ptr<const u8*>(p, 1);
  a.head = ptr<const u8*>(p, 2);
  a.perm = ptr<const int*>(p, 3);
  a.pruned = ptr<const u8*>(p, 4);
  a.pci = ptr<const u8*>(p, 5);
  a.ptheta = ptr<const int*>(p, 6);
  a.cap = ptr<const int*>(p, 7);
  a.need_relax = ptr<const u8*>(p, 8);
  a.need_restrict = ptr<const u8*>(p, 9);
  a.rank_of = ptr<int*>(p, 10);
  a.kept = ptr<u8*>(p, 11);
  a.e_code = ptr<int*>(p, 12);
  a.cand_ptheta = ptr<int*>(p, 13);
  a.f_mmask = ptr<u8*>(p, 14);
  const int K = ints[0];
  a.C = ints[1];
  if (K <= 0 || a.C <= 0) return cudaSuccess;
  remap_kernel<<<K, threads_for(a.C), 0, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}

extern "C" int layer_tail_edges(const int64_t* p, const int* ints, void* stream) {
  EdgesArgs a;
  a.i = ptr<const long long*>(p, 0);
  a.neg_order = ptr<const int*>(p, 1);
  a.so_key = ptr<const int*>(p, 2);
  a.so_negval = ptr<const int*>(p, 3);
  a.kv = ptr<const int*>(p, 4);
  a.cap = ptr<const int*>(p, 5);
  a.U = ptr<const int*>(p, 6);
  a.need_relax = ptr<const u8*>(p, 7);
  a.need_restrict = ptr<const u8*>(p, 8);
  a.perm = ptr<const int*>(p, 9);
  a.val_s = ptr<const int*>(p, 10);
  a.slot_exact = ptr<const u8*>(p, 11);
  a.skip_s = ptr<const u8*>(p, 12);
  a.f_valid = ptr<const u8*>(p, 13);
  a.f_cost = ptr<const int*>(p, 14);
  a.f_dval = ptr<const int*>(p, 15);
  a.f_skip = ptr<const u8*>(p, 16);
  a.rank_of = ptr<const int*>(p, 17);
  a.kept = ptr<const u8*>(p, 18);
  a.e_code = ptr<const int*>(p, 19);
  a.cand_ptheta = ptr<const int*>(p, 20);
  a.merged_key = ptr<const int*>(p, 21);
  a.rcost = ptr<const int*>(p, 22);
  a.l_val = ptr<const int*>(p, 23);
  a.l_mask = ptr<const u8*>(p, 24);
  a.l_exact = ptr<const u8*>(p, 25);
  a.l_relaxed = ptr<const u8*>(p, 26);
  a.l_rub = ptr<const int*>(p, 27);
  a.l_bp = ptr<const int*>(p, 28);
  a.l_bd = ptr<const int*>(p, 29);
  a.l_bs = ptr<const u8*>(p, 30);
  a.l_wlp = ptr<const u8*>(p, 31);
  a.l_wlth = ptr<const int*>(p, 32);
  a.p_val = ptr<int*>(p, 33);
  a.p_mask = ptr<u8*>(p, 34);
  a.p_exact = ptr<u8*>(p, 35);
  a.p_relaxed = ptr<u8*>(p, 36);
  a.p_rub = ptr<int*>(p, 37);
  a.p_bp = ptr<int*>(p, 38);
  a.p_bd = ptr<int*>(p, 39);
  a.p_bs = ptr<u8*>(p, 40);
  a.p_wlp = ptr<u8*>(p, 41);
  a.p_wlth = ptr<int*>(p, 42);
  a.hic = ptr<u8*>(p, 43);
  a.eptheta = ptr<int*>(p, 44);
  a.e_child = ptr<int*>(p, 45);
  a.e_cost = ptr<int*>(p, 46);
  a.e_valid = ptr<u8*>(p, 47);
  a.lel = ptr<int*>(p, 48);
  a.overflow = ptr<u8*>(p, 49);
  a.fidx = ptr<int*>(p, 50);
  a.q_valid = ptr<u8*>(p, 51);
  a.nl_val = ptr<int*>(p, 52);
  a.nl_exact = ptr<u8*>(p, 53);
  a.nl_relaxed = ptr<u8*>(p, 54);
  a.nl_bp = ptr<int*>(p, 55);
  a.nl_bd = ptr<int*>(p, 56);
  a.nl_bs = ptr<u8*>(p, 57);
  a.fresh = ptr<u8*>(p, 58);
  const int K = ints[0];
  a.C = ints[1];
  a.W = ints[2];
  a.n = ints[3];
  a.Kk = ints[4];
  if (K <= 0 || a.C <= 0) return cudaSuccess;
  const size_t smem = (size_t)12 * a.W;
  cudaError_t err = allow_smem((const void*)edges_kernel, smem);
  if (err != cudaSuccess) return err;
  edges_kernel<<<K, threads_for(a.C), smem, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}

extern "C" int layer_tail_dominance(const int64_t* p, const int* ints, void* stream) {
  DomArgs a;
  a.i = ptr<long long*>(p, 0);
  a.fidx = ptr<const int*>(p, 1);
  a.q_valid = ptr<const u8*>(p, 2);
  a.nl_val = ptr<const int*>(p, 3);
  a.nl_exact = ptr<const u8*>(p, 4);
  a.nl_relaxed = ptr<const u8*>(p, 5);
  a.nl_bp = ptr<const int*>(p, 6);
  a.nl_bd = ptr<const int*>(p, 7);
  a.nl_bs = ptr<const u8*>(p, 8);
  a.fresh = ptr<const u8*>(p, 9);
  a.dkey = ptr<const int*>(p, 10);
  a.dcoord = ptr<const int*>(p, 11);
  a.c_ebp = ptr<const u8*>(p, 12);
  a.val = ptr<int*>(p, 13);
  a.mask = ptr<u8*>(p, 14);
  a.exact = ptr<u8*>(p, 15);
  a.relaxed = ptr<u8*>(p, 16);
  a.bp = ptr<int*>(p, 17);
  a.bd = ptr<int*>(p, 18);
  a.bs = ptr<u8*>(p, 19);
  a.ebp = ptr<u8*>(p, 20);
  a.wlp = ptr<u8*>(p, 21);
  a.wlth = ptr<int*>(p, 22);
  const int K = ints[0];
  a.W = ints[1];
  a.KK = ints[2];
  a.CC = ints[3];
  a.use_value = ints[4];
  a.wl = ints[5];
  if (K <= 0 || a.W <= 0) return cudaSuccess;
  // threads a node: as many as leave W nodes within 1,024 threads, a power
  // of two up to a warp
  const int W32 = (a.W + 31) / 32 * 32;
  a.split = 1;
  while (a.split < 32 && (long long)W32 * a.split * 2 <= 1024) a.split *= 2;
  const size_t smem = (size_t)8 * a.W;
  cudaError_t err = allow_smem((const void*)dominance_kernel, smem);
  if (err != cudaSuccess) return err;
  dominance_kernel<<<K, threads_for((long long)a.W * a.split), smem, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}
