// K2: fused bottom-up backward sweep (ddo_tpu_torch/engine/backward.py).
//
// Replaces the Pallas kernels `_pallas_kernel` (behind `backward_pallas`,
// one lane) and `_pallas_kernel_batched` (behind `backward_pallas_batched`,
// K lanes) of ddo_tpu/engine/backward.py.  Per lane it walks the n layers
// bottom-up and computes, in one pass, the local bounds (reference
// clean.rs:448-475) and the thresholds (clean.rs:478-532) of every node:
// the semantics of `_layer_body` (backward.py:58-115), rule for rule.
//
// What bounds it: each layer needs layer l+1's carries, so the n layers
// run in series, but a layer's inputs (11 planes, 9*W*D + 20*W bytes) do
// not depend on them and can be fetched ahead.  One SM streams at (bytes
// in flight) / (memory latency), so the routes differ in how many bytes
// they keep in flight and how many SMs one lane uses.  Tensor cores have
// nothing to offer this integer max/min/select work.  Three routes,
// chosen by engine/backward.py `backward_plan`:
//
// "direct" (the first design; W % 16 != 0 or planes off 16-byte
// boundaries, which no bulk copy takes): one CTA per lane, one thread
// per node slot, the layer loop inside the kernel, the child layer's
// carries (vb_eff, th_eff: two int32 [W] rows) double-buffered in shared
// memory, one __syncthreads per layer.  Each thread reduces its node's D
// out-edges with native indexed loads straight from device memory.
//
// "tma" (low branching: two blocks of one layer fit shared memory): the
// same sweep, with the ring holding blocks of B consecutive layers (B = 8
// at W=256, D=2), contiguous in every plane, so a block is 11 bulk copies
// by the Tensor Memory Accelerator of up to 16 KB.  One block loads while
// the block before it computes.  At K=128, n=2000, W=256, D=2 the sweep
// must read 2,516,582,400 B and write 655,360,000 B (0.94 ms at 3.35
// TB/s); 128 CTAs fill 128 of the H100's 132 SMs.
//
// "stream" (high branching, or very wide layers): a ring of R sub-layer
// chunks of S node slots (their S*D edges and S entries of each node
// plane: 11 bulk copies on one mbarrier), refilled by whichever warp
// finishes a chunk last, so chunks of the next layers arrive while this
// one computes.  A chunk's edges are read one per lane, consecutive lanes
// on consecutive edges (conflict-free in shared memory at any D), and
// each node's D contributions are reduced over a group of G lanes (a
// warp when D > 16, by a reduce-scatter over its nodes); then each lane
// applies the node rules to one node.  At TSPTW N60's shape, 128 lanes x
// 61 layers x W=256 x D=61, the sweep reads 1,137 MB (0.35 ms at 3.35
// TB/s) in chunks of 128 slots, 3 in the ring.  With few lanes, a
// thread-block cluster of c CTAs takes one lane: each CTA streams W/c
// slots and holds a full copy of the carries; at a layer's end it copies
// its slice of the new carries into every peer's shared memory with bulk
// copies (cp.async.bulk shared::cta -> shared::cluster) that complete on
// the peer's mbarrier, so the layer chain runs on c SMs with no
// cluster-wide barrier inside it.  That exchange sits on every layer's
// critical path and bounds a clustered lane (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#define INF_ 1073741823  // (1 << 30) - 1, utils/num.py
#define NEG_INF_ (-INF_)

struct BwdArgs {
  // inputs
  const int* child;        // [K, n, C]
  const int* cost;         // [K, n, C]
  const uint8_t* valid;    // [K, n, C]
  const int* val;          // [K, n, W]
  const int* rub;          // [K, n, W]
  const uint8_t* cutflag;  // [K, n, W]
  const uint8_t* exact;    // [K, n, W]
  const uint8_t* mask;     // [K, n, W]
  const int* ep_theta;     // [K, n, W]
  const uint8_t* wlp;      // [K, n, W]
  const int* wlth;         // [K, n, W]
  const int* vb_init;      // [K, W]
  const int* th_init;      // [K, W]
  const int* best_known;   // [K]
  // outputs
  int* vb_out;             // [K, n, W]
  uint8_t* mk_out;         // [K, n, W]
  int* th_out;             // [K, n, W]
  uint8_t* hs_out;         // [K, n, W]
};

// One layer's input rows, in device or in shared memory.
struct LayerRows {
  const int *child, *cost, *val, *rub, *ep, *wlth;
  const uint8_t *valid, *cutflag, *exact, *mask, *wlp;
};

// A ring slot holds a block of B consecutive layers ("tma") or a chunk of
// S node slots of one layer ("stream") of the 11 input planes: the byte
// offset of each plane's rows in the slot, in LayerRows order (child,
// cost, val, rub, ep, wlth, valid, cutflag, exact, mask, wlp), then the
// slot's size (engine/backward.py `backward_plan`).
#define RING_ROWS 11
struct Ring {
  int off[RING_ROWS];
  int bytes;
};

// saturating int32 arithmetic; the sum wraps first, exactly like XLA's
// int32 add followed by the clip in utils/num.py
__device__ __forceinline__ int sat(int s) { return min(max(s, NEG_INF_), INF_); }
__device__ __forceinline__ int sat_add(int a, int b) {
  return sat((int)((unsigned)a + (unsigned)b));
}
__device__ __forceinline__ int sat_sub(int a, int b) {
  return sat((int)((unsigned)a - (unsigned)b));
}

// A node's rules after its out-edges are reduced (vb_l, mk: local bound;
// th_l, hs: child thresholds): thetas of filter-pruned children, the
// threshold rules, within-layer dominance.  Writes the node's four outputs
// at i and returns its carries for the parent layer in vbe, the.
__device__ __forceinline__ void finish_node(const BwdArgs& a, size_t i, int vb_l, int th_l,
                                            bool mk, bool hs, int ep, int val, int rub, int wlth,
                                            bool alive, bool cutf, bool ex, bool wlp, int bk,
                                            int& vbe, int& the) {
  // theta of filter-pruned children that never materialized
  th_l = min(th_l, ep);
  hs = hs || ep < INF_;
  if (!hs) th_l = INF_;

  // thresh_rules (backward.py:42-55, clean.rs:503-517)
  const bool b1 = sat_add(val, rub) <= bk;
  const int th1 = sat_sub(bk, rub);
  const int th2a = min(hs ? th_l : INF_, sat_sub(bk, vb_l));
  const int th2 = sat_add(val, vb_l) <= bk ? th2a : val;
  const bool b3 = ex && !hs;
  const int new_th = b1 ? th1 : (cutf ? th2 : (b3 ? INF_ : th_l));
  const bool new_hs = hs || b1 || cutf || b3;
  if (alive) {
    th_l = new_th;
    hs = new_hs;
  }
  // within-layer dominance: a pruned row's theta is its threshold
  const bool use_wl = wlp && wlth < INF_;
  if (use_wl) th_l = wlth;
  hs = hs || use_wl;

  a.vb_out[i] = vb_l;
  a.mk_out[i] = mk;
  a.th_out[i] = th_l;
  a.hs_out[i] = hs;
  vbe = mk ? vb_l : NEG_INF_;
  the = (hs && (alive || use_wl)) ? th_l : INF_;
}

// One out-edge folded into its node's reductions (local bound vb_l and
// its mark mk; child threshold th_l and its flag hs): `ok` says the edge
// is valid with a child, g_vb and g_th are the child's carries (g_th INF
// when not ok).
__device__ __forceinline__ void fold_edge(bool ok, int eco, int g_vb, int g_th, int& vb_l,
                                          bool& mk, int& th_l, bool& hs) {
  const bool cm = ok && g_vb > NEG_INF_;
  vb_l = max(vb_l, cm ? sat_add(g_vb, eco) : NEG_INF_);
  mk = mk || cm;
  const bool ch = g_th < INF_;
  th_l = min(th_l, ch ? sat_sub(g_th, eco) : INF_);
  hs = hs || ch;
}

// Layer l of one lane: reads the child carries (vbc, thc), writes this
// layer's carries (vbn, thn) and its four output rows at node0.
__device__ __forceinline__ void sweep_layer(const BwdArgs& a, const LayerRows& r,
                                            const int* vbc, const int* thc, int* vbn,
                                            int* thn, size_t node0, int W, int D, int bk) {
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    // the node's own inputs first: their loads overlap the edges'
    const int ep = r.ep[w], val = r.val[w], rub = r.rub[w], wlth = r.wlth[w];
    const bool alive = r.mask[w], cutf = r.cutflag[w], ex = r.exact[w], wlp = r.wlp[w];
    // local bounds and child thresholds over the node's D out-edges
    int vb_l = NEG_INF_, th_l = INF_;
    bool mk = false, hs = false;
    for (int d = 0; d < D; ++d) {
      const int e = w * D + d;
      const int ec = r.child[e];
      const int eco = r.cost[e];
      const bool ok = r.valid[e] && ec >= 0;
      const int cc = min(max(ec, 0), W - 1);
      fold_edge(ok, eco, vbc[cc], ok ? thc[cc] : INF_, vb_l, mk, th_l, hs);
    }
    int vbe, the;
    finish_node(a, node0 + w, vb_l, th_l, mk, hs, ep, val, rub, wlth, alive, cutf, ex, wlp, bk,
                vbe, the);
    vbn[w] = vbe;
    thn[w] = the;
  }
}

__device__ __forceinline__ LayerRows device_rows(const BwdArgs& a, size_t row, int W, int C) {
  LayerRows r;
  r.child = a.child + row * C;
  r.cost = a.cost + row * C;
  r.val = a.val + row * W;
  r.rub = a.rub + row * W;
  r.ep = a.ep_theta + row * W;
  r.wlth = a.wlth + row * W;
  r.valid = a.valid + row * C;
  r.cutflag = a.cutflag + row * W;
  r.exact = a.exact + row * W;
  r.mask = a.mask + row * W;
  r.wlp = a.wlp + row * W;
  return r;
}

__device__ __forceinline__ void load_carries(const BwdArgs& a, int* vb_buf, int* th_buf,
                                             int k, int W) {
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    vb_buf[w] = a.vb_init[(size_t)k * W + w];
    th_buf[w] = a.th_init[(size_t)k * W + w];
  }
}

// ------------------------------------------------------------- route "direct"
__global__ void __launch_bounds__(1024) backward_direct_kernel(BwdArgs a, int n, int W, int D) {
  extern __shared__ int sm[];
  int* vb_buf = sm;          // [2][W]
  int* th_buf = sm + 2 * W;  // [2][W]
  const int k = blockIdx.x;
  const int bk = a.best_known[k];
  load_carries(a, vb_buf, th_buf, k, W);
  __syncthreads();

  int cur = 0;
  for (int l = n - 1; l >= 0; --l) {
    const size_t row = (size_t)k * n + l;
    sweep_layer(a, device_rows(a, row, W, W * D), vb_buf + cur * W, th_buf + cur * W,
                vb_buf + (1 - cur) * W, th_buf + (1 - cur) * W, row * W, W, D, bk);
    __syncthreads();
    cur = 1 - cur;
  }
}

// ---------------------------------------------------------------- route "tma"
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tLAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@p bra DONE;\n\tbra LAB_WAIT;\n\tDONE:\n\t}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// by the Tensor Memory Accelerator, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const void* src, unsigned bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Edges e0 .. e0+e-1 and node entries v0 .. v0+v-1 of the 11 planes into
// slot s: 11 bulk copies completing on `bar`.
__device__ __forceinline__ void stage(const BwdArgs& a, const Ring& g, char* s, uint64_t* bar,
                                      size_t e0, unsigned e, size_t v0, unsigned v) {
  mbar_expect_tx(bar, 9 * e + 20 * v);
  tma_load(s + g.off[0], a.child + e0, 4 * e, bar);
  tma_load(s + g.off[1], a.cost + e0, 4 * e, bar);
  tma_load(s + g.off[2], a.val + v0, 4 * v, bar);
  tma_load(s + g.off[3], a.rub + v0, 4 * v, bar);
  tma_load(s + g.off[4], a.ep_theta + v0, 4 * v, bar);
  tma_load(s + g.off[5], a.wlth + v0, 4 * v, bar);
  tma_load(s + g.off[6], a.valid + e0, e, bar);
  tma_load(s + g.off[7], a.cutflag + v0, v, bar);
  tma_load(s + g.off[8], a.exact + v0, v, bar);
  tma_load(s + g.off[9], a.mask + v0, v, bar);
  tma_load(s + g.off[10], a.wlp + v0, v, bar);
}

// Rows lo .. lo+count-1 of the lane's planes into slot s.
__device__ __forceinline__ void stage_block(const BwdArgs& a, const Ring& g, char* s,
                                            uint64_t* bar, size_t lo, int count, int W, int C) {
  stage(a, g, s, bar, lo * C, (unsigned)count * C, lo * W, (unsigned)count * W);
}

// Row i of the block staged in slot s.
__device__ __forceinline__ LayerRows slot_rows(const Ring& g, const char* s, int i, int W,
                                               int C) {
  LayerRows r;
  r.child = (const int*)(s + g.off[0]) + (size_t)i * C;
  r.cost = (const int*)(s + g.off[1]) + (size_t)i * C;
  r.val = (const int*)(s + g.off[2]) + (size_t)i * W;
  r.rub = (const int*)(s + g.off[3]) + (size_t)i * W;
  r.ep = (const int*)(s + g.off[4]) + (size_t)i * W;
  r.wlth = (const int*)(s + g.off[5]) + (size_t)i * W;
  r.valid = (const uint8_t*)(s + g.off[6]) + (size_t)i * C;
  r.cutflag = (const uint8_t*)(s + g.off[7]) + (size_t)i * W;
  r.exact = (const uint8_t*)(s + g.off[8]) + (size_t)i * W;
  r.mask = (const uint8_t*)(s + g.off[9]) + (size_t)i * W;
  r.wlp = (const uint8_t*)(s + g.off[10]) + (size_t)i * W;
  return r;
}

// Blocks of B layers, taken from the top: block b holds layers
// max(0, hi-B+1) .. hi, hi = n-1-b*B, and lives in slot b % 2 of a
// two-slot ring.  Thread 0 stages blocks 0 and 1 up front, then block b+1
// as block b begins (its slot's previous block, b-1, is done by then), so
// one block of B layers is always in flight while another computes.  A
// block is contiguous in every plane, so each of its 11 rows is one bulk
// copy of B rows.  At a block's first layer every thread waits on the
// slot's mbarrier, at phase (b / 2) mod 2.
__global__ void __launch_bounds__(1024) backward_tma_kernel(BwdArgs a, Ring g, int n, int W,
                                                            int D, int B) {
  extern __shared__ __align__(16) char smem[];
  int* vb_buf = (int*)smem;      // [2][W]
  int* th_buf = vb_buf + 2 * W;  // [2][W]
  char* ring = smem + 16 * (size_t)W;  // [2][g.bytes]
  uint64_t* bar = (uint64_t*)(ring + 2 * (size_t)g.bytes);  // [2]
  const int k = blockIdx.x;
  const int C = W * D;
  const int bk = a.best_known[k];
  const size_t row0 = (size_t)k * n;
  const int nblocks = (n + B - 1) / B;
  auto stage = [&](int b) {
    const int hi = n - 1 - b * B, lo = max(0, hi - B + 1);
    stage_block(a, g, ring + (b & 1) * (size_t)g.bytes, bar + (b & 1), row0 + lo, hi - lo + 1,
                W, C);
  };
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int b = 0; b < 2 && b < nblocks; ++b) stage(b);
  }
  load_carries(a, vb_buf, th_buf, k, W);

  int cur = 0;
  for (int l = n - 1; l >= 0; --l) {
    __syncthreads();  // layer l+1's carries written; at a block's top, the block before is done
    const int b = (n - 1 - l) / B, hi = n - 1 - b * B;
    if (l == hi) {  // a block's first layer
      if (threadIdx.x == 0 && b >= 1 && b + 1 < nblocks) stage(b + 1);
      mbar_wait(bar + (b & 1), (b >> 1) & 1);
    }
    const size_t row = row0 + l;
    const LayerRows r =
        slot_rows(g, ring + (b & 1) * (size_t)g.bytes, l - max(0, hi - B + 1), W, C);
    sweep_layer(a, r, vb_buf + cur * W, th_buf + cur * W, vb_buf + (1 - cur) * W,
                th_buf + (1 - cur) * W, row * W, W, D, bk);
    cur = 1 - cur;
  }
}

// ------------------------------------------------------------- route "stream"
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
// every thread of every CTA of the cluster
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of the same shared-memory byte in cluster CTA `rank`
__device__ __forceinline__ unsigned peer_addr(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// `bytes` of this CTA's shared memory at src into a peer's at dst (both
// from peer_addr), completing on the peer's mbarrier at bar
__device__ __forceinline__ void copy_to_peer(unsigned dst, const void* src, unsigned bytes,
                                             unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(smem_u32(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Chunk i of a CTA's sequence: layer n-1 - i/P, node slots w0 + (i%P)*S
// .. +S-1 of the lane's row, staged into ring slot i % R.
struct StreamGeom {
  int n, W, D, S, R, P, w0;
  size_t row0;
};
__device__ __forceinline__ void stage_chunk(const BwdArgs& a, const Ring& g, char* ring,
                                            uint64_t* full, const StreamGeom& m, int i) {
  const int s = i % m.R;
  const size_t row = m.row0 + (m.n - 1 - i / m.P);
  const size_t slot0 = (size_t)m.w0 + (size_t)(i % m.P) * m.S;
  stage(a, g, ring + (size_t)s * g.bytes, full + s, (row * m.W + slot0) * m.D,
        (unsigned)(m.S * m.D), row * m.W + slot0, (unsigned)m.S);
}

// The U nodes' partial reductions each lane holds (v: max, t: min, f: or)
// reduced over the warp and scattered: halving steps at offsets 16, 8,
// ... leave each lane half of its partner's and its own nodes (U - 1
// shuffles of each value in all, against 5 U for a reduction per node),
// then xor steps finish the lanes that share a node.  Lane L ends with
// node sum_j bit(L, 4 - j) * U / 2^(j+1) in v[0], t[0], f[0].
template <int U>
__device__ __forceinline__ void scatter_reduce(int (&v)[U], int (&t)[U], int (&f)[U], int lane) {
  int o = 16;
#pragma unroll
  for (int half = U / 2; half >= 1; half /= 2, o /= 2) {
    const bool upper = lane & o;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const int sv = upper ? v[i] : v[i + half], st = upper ? t[i] : t[i + half],
                sf = upper ? f[i] : f[i + half];
      if (upper) {
        v[i] = v[i + half];
        t[i] = t[i + half];
        f[i] = f[i + half];
      }
      v[i] = max(v[i], __shfl_xor_sync(0xffffffffu, sv, o));
      t[i] = min(t[i], __shfl_xor_sync(0xffffffffu, st, o));
      f[i] = f[i] | __shfl_xor_sync(0xffffffffu, sf, o);
    }
  }
  for (; o >= 1; o /= 2) {
    v[0] = max(v[0], __shfl_xor_sync(0xffffffffu, v[0], o));
    t[0] = min(t[0], __shfl_xor_sync(0xffffffffu, t[0], o));
    f[0] = f[0] | __shfl_xor_sync(0xffffffffu, f[0], o);
  }
}

// A warp's nodes of one chunk, q0 .. q0+M-1, U passes at a time: pass p
// gives node p*npw + grp to the group of G lanes grp, whose lanes fold
// edges d = sub, sub+G, ... of it; the U passes' edge folds interleave,
// so U independent chains are in flight.  A warp per node (G = 32) with
// U > 1 reduces by `scatter_reduce`; else each node by xor shuffles over
// its group and ballots.  Node q0 + j's results end in lane j (vb_m,
// th_m, mk_m, hs_m).
template <int U>
__device__ __forceinline__ void reduce_nodes(const LayerRows& r, const int2* car, int W, int D,
                                             int S, int G, int M, int q0, int& vb_m, int& th_m,
                                             bool& mk_m, bool& hs_m) {
  const int lane = threadIdx.x & 31, npw = 32 / G, sub = lane % G, grp = lane / G;
  const unsigned gbits = G == 32 ? 0xffffffffu : ((1u << G) - 1u);
  for (int p0 = 0; p0 * npw < M; p0 += U) {  // warp-uniform
    int vb[U], th[U], q[U];
    bool mk[U], hs[U], has[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int mi = (p0 + u) * npw + grp;
      q[u] = q0 + mi;
      has[u] = mi < M && q[u] < S;
      vb[u] = NEG_INF_;
      th[u] = INF_;
      mk[u] = hs[u] = false;
    }
    for (int d = sub; d < D; d += G) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (has[u]) {
          const int e = q[u] * D + d;
          const int ec = r.child[e];
          const int eco = r.cost[e];
          const bool ok = r.valid[e] && ec >= 0;
          const int2 gc = car[min(max(ec, 0), W - 1)];
          fold_edge(ok, eco, gc.x, ok ? gc.y : INF_, vb[u], mk[u], th[u], hs[u]);
        }
      }
    }
    if (U > 1 && G == 32) {
      int fl[U];
#pragma unroll
      for (int u = 0; u < U; ++u) fl[u] = (int)mk[u] | ((int)hs[u] << 1);
      scatter_reduce<U>(vb, th, fl, lane);
      // lane p0 + j takes node j from the lane scatter_reduce left it in
      const int j = lane - p0;
      int src = 0;
#pragma unroll
      for (int b = 1, o = 16; b < U; b *= 2, o /= 2)
        if (j & (U / 2 / b)) src |= o;
      const int v1 = __shfl_sync(0xffffffffu, vb[0], src);
      const int t1 = __shfl_sync(0xffffffffu, th[0], src);
      const int f1 = __shfl_sync(0xffffffffu, fl[0], src);
      if (j >= 0 && j < U) {
        vb_m = v1;
        th_m = t1;
        mk_m = f1 & 1;
        hs_m = f1 & 2;
      }
      continue;
    }
    for (int o = G >> 1; o; o >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        vb[u] = max(vb[u], __shfl_xor_sync(0xffffffffu, vb[u], o));
        th[u] = min(th[u], __shfl_xor_sync(0xffffffffu, th[u], o));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned bm = __ballot_sync(0xffffffffu, mk[u]);
      const unsigned bh = __ballot_sync(0xffffffffu, hs[u]);
      const int from = lane - (p0 + u) * npw;  // the group whose node this lane keeps
      const bool mine = from >= 0 && from < npw;
      const int src = mine ? from * G : 0;
      const int v1 = __shfl_sync(0xffffffffu, vb[u], src);
      const int t1 = __shfl_sync(0xffffffffu, th[u], src);
      if (mine) {
        vb_m = v1;
        th_m = t1;
        mk_m = (bm >> src) & gbits;
        hs_m = (bh >> src) & gbits;
      }
    }
  }
}

// Block k / c of the grid sweeps lane k; within a cluster of c CTAs, CTA
// `rank` owns node slots [rank*W/c, (rank+1)*W/c), in P chunks of S per
// layer.  Shared memory: R mbarriers (ring slot full), 2 mbarriers (a
// carries buffer's peer slices landed), R counters (warps done with the
// slot's chunk), the carries as (vb_eff, th_eff) pairs [2][W], then the
// ring of R slots of g.bytes.  Thread 0 stages the first R chunks; after
// that the last warp to finish chunk i stages chunk i+R into its slot, so
// up to R chunks, across layer boundaries, are in flight or ready.
// Within a chunk, warp w takes nodes [w*M, (w+1)*M), M = ceil(S /
// warps), through `reduce_nodes`; its M lanes then apply the node rules
// at once and write the outputs and the new carries.  At a layer's end,
// in a cluster, lanes of warp 0 copy the CTA's slice of the new carries
// into every peer (one bulk copy each, completing on the peer's mbarrier
// of that buffer), and every thread waits until its peers' slices have
// landed: no cluster-wide barrier inside the layer loop.
template <int U>
__global__ void __launch_bounds__(U >= 8 ? 512 : 1024)
    backward_stream_kernel(BwdArgs a, Ring g, int n, int W, int D, int S, int R, int G) {
  extern __shared__ __align__(16) char smem[];
  uint64_t* full = (uint64_t*)smem;                          // [R]
  uint64_t* landed = full + R;                               // [2]
  int* done = (int*)(landed + 2);                            // [R]
  int2* car = (int2*)(smem + ((12 * (size_t)R + 31) & ~(size_t)15));  // [2][W]
  char* ring = (char*)(car + 2 * (size_t)W);                 // [R][g.bytes]
  const int c = (int)cluster_size(), rank = (int)cluster_rank();
  const int k = blockIdx.x / c;
  StreamGeom m;
  m.n = n;
  m.W = W;
  m.D = D;
  m.S = S;
  m.R = R;
  m.P = W / c / S;
  m.w0 = rank * (W / c);
  m.row0 = (size_t)k * n;
  const int total = n * m.P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int bk = a.best_known[k];
  const unsigned slice = (unsigned)(W / c) * sizeof(int2);
  if (threadIdx.x == 0) {
    for (int s = 0; s < R; ++s) {
      mbar_init(full + s, 1);
      done[s] = 0;
    }
    mbar_init(landed, 1);
    mbar_init(landed + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < R && i < total; ++i) stage_chunk(a, g, ring, full, m, i);
  }
  for (int w = threadIdx.x; w < W; w += blockDim.x)
    car[w] = make_int2(a.vb_init[(size_t)k * W + w], a.th_init[(size_t)k * W + w]);
  if (c > 1)
    cluster_sync();  // barriers live in every CTA of the cluster
  else
    __syncthreads();

  const int M = (S + nwarps - 1) / nwarps;  // nodes per warp per chunk
  int cur = 0;
  for (int l = n - 1; l >= 0; --l) {
    const int2* carc = car + (size_t)cur * W;
    int2* carn = car + (size_t)(1 - cur) * W;
    const size_t node_row = (m.row0 + l) * W;
    for (int j = 0; j < m.P; ++j) {
      const int i = (n - 1 - l) * m.P + j, s = i % R;
      mbar_wait(full + s, (i / R) & 1);
      const LayerRows r = slot_rows(g, ring + (size_t)s * g.bytes, 0, S, S * D);
      const int q0 = warp * M;  // the warp's first node of the chunk
      int vb_m = NEG_INF_, th_m = INF_;
      bool mk_m = false, hs_m = false;
      reduce_nodes<U>(r, carc, W, D, S, G, M, q0, vb_m, th_m, mk_m, hs_m);
      const int q = q0 + lane;
      if (lane < M && q < S) {
        const int w = m.w0 + j * S + q;
        int vbe, the;
        finish_node(a, node_row + w, vb_m, th_m, mk_m, hs_m, r.ep[q], r.val[q], r.rub[q],
                    r.wlth[q], r.mask[q], r.cutflag[q], r.exact[q], r.wlp[q], bk, vbe, the);
        carn[w] = make_int2(vbe, the);
      }
      // the chunk's slot is free once every warp is done with it: the
      // last warp to get here stages chunk i + R into it
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        if (atomicAdd(done + s, 1) == nwarps - 1) {
          done[s] = 0;
          __threadfence_block();
          if (i + R < total) stage_chunk(a, g, ring, full, m, i + R);
        }
      }
    }
    if (c > 1 && l > 0) {
      // this layer's carries: the CTA's slice to every peer, then the
      // peers' slices in; a peer's copy into buffer 1-cur for the layer
      // after next waits until every CTA has read it for this one
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      const int b = 1 - cur;
      if (warp == 0 && lane < c) {  // lane t copies to CTA rank + t
        if (lane == 0) {
          mbar_expect_tx(landed + b, (unsigned)(c - 1) * slice);
        } else {
          const unsigned peer = (unsigned)((rank + lane) % c);
          copy_to_peer(peer_addr(smem_u32(carn + m.w0), peer), carn + m.w0, slice,
                       peer_addr(smem_u32(landed + b), peer));
        }
      }
      // buffer b completes a phase every other layer: layers n-1, n-3,
      // ... fill buffer 1, the others buffer 0
      mbar_wait(landed + b, ((n - 1 - l) >> 1) & 1);
    } else {
      __syncthreads();
    }
    cur = 1 - cur;
  }
  if (c > 1) cluster_sync();  // no CTA leaves while a peer's copy may read it
}

// ---------------------------------------------------------------- entry point
static cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// `ptrs` is a host array of the 18 device pointers in BwdArgs order;
// `plan` (engine/backward.py `BackwardPlan.ints`) holds the route (0
// direct, 1 tma, 2 stream), its block (tma: layers per ring block;
// stream: node slots per chunk), the ring depth, the cluster size, the
// group size, the unroll (stream: node passes in flight, 1, 2, 4 or 8),
// the threads per CTA, then a ring slot's RING_ROWS plane offsets and its
// size in bytes.  Returns 0 or a CUDA error code.
extern "C" int fused_backward(const int64_t* ptrs, const int* plan, int K, int n, int W, int D,
                              void* stream) {
  BwdArgs a;
  a.child = reinterpret_cast<const int*>(ptrs[0]);
  a.cost = reinterpret_cast<const int*>(ptrs[1]);
  a.valid = reinterpret_cast<const uint8_t*>(ptrs[2]);
  a.val = reinterpret_cast<const int*>(ptrs[3]);
  a.rub = reinterpret_cast<const int*>(ptrs[4]);
  a.cutflag = reinterpret_cast<const uint8_t*>(ptrs[5]);
  a.exact = reinterpret_cast<const uint8_t*>(ptrs[6]);
  a.mask = reinterpret_cast<const uint8_t*>(ptrs[7]);
  a.ep_theta = reinterpret_cast<const int*>(ptrs[8]);
  a.wlp = reinterpret_cast<const uint8_t*>(ptrs[9]);
  a.wlth = reinterpret_cast<const int*>(ptrs[10]);
  a.vb_init = reinterpret_cast<const int*>(ptrs[11]);
  a.th_init = reinterpret_cast<const int*>(ptrs[12]);
  a.best_known = reinterpret_cast<const int*>(ptrs[13]);
  a.vb_out = reinterpret_cast<int*>(ptrs[14]);
  a.mk_out = reinterpret_cast<uint8_t*>(ptrs[15]);
  a.th_out = reinterpret_cast<int*>(ptrs[16]);
  a.hs_out = reinterpret_cast<uint8_t*>(ptrs[17]);
  const int route = plan[0], block = plan[1], depth = plan[2], cluster = plan[3],
            group = plan[4], unroll = plan[5], threads = plan[6];
  Ring g;
  for (int i = 0; i < RING_ROWS; ++i) g.off[i] = plan[7 + i];
  g.bytes = plan[7 + RING_ROWS];
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (route == 0) {
    const size_t smem = (size_t)16 * W;
    err = allow_smem((const void*)backward_direct_kernel, smem);
    if (err != cudaSuccess) return err;
    backward_direct_kernel<<<K, threads, smem, s>>>(a, n, W, D);
    return cudaGetLastError();
  }
  if (route == 1) {
    const size_t smem = (size_t)16 * W + 2 * (size_t)g.bytes + 2 * sizeof(uint64_t);
    err = allow_smem((const void*)backward_tma_kernel, smem);
    if (err != cudaSuccess) return err;
    backward_tma_kernel<<<K, threads, smem, s>>>(a, g, n, W, D, block);
    return cudaGetLastError();
  }
  if (route != 2) return cudaErrorInvalidValue;
  const size_t smem =
      ((12 * (size_t)depth + 31) & ~(size_t)15) + (size_t)16 * W + (size_t)depth * g.bytes;
  void (*kernel)(BwdArgs, Ring, int, int, int, int, int, int) =
      unroll == 1   ? backward_stream_kernel<1>
      : unroll == 2 ? backward_stream_kernel<2>
      : unroll == 4 ? backward_stream_kernel<4>
      : unroll == 8 ? backward_stream_kernel<8>
                    : nullptr;
  if (!kernel || (unroll == 8 && threads > 512)) return cudaErrorInvalidValue;
  err = allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a, g, n, W, D, block, depth, group);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// How many clusters of c "stream" CTAs of `threads` threads and `smem`
// bytes of shared memory the card holds at once (engine/backward.py
// CLUSTERS_RESIDENT); a negative CUDA error code on failure.
extern "C" int stream_resident_clusters(int c, int smem, int threads) {
  const void* kernel = (const void*)backward_stream_kernel<4>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err == cudaSuccess && c > 8)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int held = 0;
  err = cudaOccupancyMaxActiveClusters(&held, kernel, &cfg);
  return err == cudaSuccess ? held : -(int)err;
}
