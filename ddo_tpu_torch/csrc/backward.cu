// K2: fused bottom-up backward sweep (ddo_tpu_torch/engine/backward.py).
//
// Replaces the Pallas kernels `_pallas_kernel` (behind `backward_pallas`,
// one lane) and `_pallas_kernel_batched` (behind `backward_pallas_batched`,
// K lanes) of ddo_tpu/engine/backward.py.  Per lane it walks the n layers
// bottom-up and computes, in one pass, the local bounds (reference
// clean.rs:448-475) and the thresholds (clean.rs:478-532) of every node:
// the semantics of `_layer_body` (backward.py:58-115), rule for rule.
//
// Design: one CTA per lane, one thread per node slot (a strided loop when
// W exceeds the block).  The layer loop runs inside the kernel, from n-1
// down to 0.  The child layer's effective carries (vb_eff, th_eff: two
// int32 [W] rows) live in shared memory, double-buffered, so each layer
// costs one __syncthreads.  Each thread reduces its node's D out-edges
// with native indexed loads of the child carries; no one-hot products and
// no 12-bit splits, which the TPU needed to gather.
//
// What bounds it: each layer needs layer l+1's carries, so the n layers
// run in series, but a layer's inputs (11 planes, 9*W*D + 20*W bytes) do
// not depend on them, so the "tma" route fetches them ahead.  One SM
// streams at (bytes in flight) / (memory latency), and the Tensor Memory
// Accelerator keeps few copies in flight, so a layer's 11 rows (256 B -
// 2 KB each at W=256) are too small to stream: the ring
// holds blocks of B consecutive layers (B = 8 at W=256, D=2), which are
// contiguous in every plane, so a block is 11 bulk copies of up to 16 KB.
// One block loads while the block before it computes; thread 0 issues
// the copies and the threads wait on the slot's mbarrier.  A bulk copy
// needs 16-byte aligned rows that are a multiple of 16 bytes, so the
// route takes W % 16 == 0 and aligned planes (the solver's W is a power of
// two >= 8); any other W, and a W too large for two blocks of one layer,
// takes the "direct" route: the same sweep reading each layer's inputs
// from device memory as it computes it (the earlier design).  At K=128,
// n=2000, W=256, D=2 the sweep must read 2,516,582,400 B and write
// 655,360,000 B (0.94 ms at 3.35 TB/s); 128 CTAs fill 128 of the H100's
// 132 SMs.  With one lane the bound is the layer chain itself: dependent
// shared-memory loads, integer selects and one barrier per layer.  Tensor
// cores have nothing to offer integer max/min/select work.

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

// A ring slot holds a block of B consecutive layers of the 11 input
// planes: the byte offset of each plane's B rows in the slot, in
// LayerRows order (child, cost, val, rub, ep, wlth, valid, cutflag, exact,
// mask, wlp), then the slot's size (engine/backward.py `backward_plan`).
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
      const int g_vb = vbc[cc];
      const bool cm = ok && g_vb > NEG_INF_;
      vb_l = max(vb_l, cm ? sat_add(g_vb, eco) : NEG_INF_);
      mk = mk || cm;
      const int g_th = ok ? thc[cc] : INF_;
      const bool ch = g_th < INF_;
      th_l = min(th_l, ch ? sat_sub(g_th, eco) : INF_);
      hs = hs || ch;
    }
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

    const size_t i = node0 + w;
    a.vb_out[i] = vb_l;
    a.mk_out[i] = mk;
    a.th_out[i] = th_l;
    a.hs_out[i] = hs;
    vbn[w] = mk ? vb_l : NEG_INF_;
    thn[w] = (hs && (alive || use_wl)) ? th_l : INF_;
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

// Rows lo .. lo+count-1 of the lane's planes into slot s: 11 bulk copies.
__device__ __forceinline__ void stage_block(const BwdArgs& a, const Ring& g, char* s,
                                            uint64_t* bar, size_t lo, int count, int W, int C) {
  const LayerRows r = device_rows(a, lo, W, C);
  const unsigned e = (unsigned)count * C, v = (unsigned)count * W;
  mbar_expect_tx(bar, 9 * e + 20 * v);
  tma_load(s + g.off[0], r.child, 4 * e, bar);
  tma_load(s + g.off[1], r.cost, 4 * e, bar);
  tma_load(s + g.off[2], r.val, 4 * v, bar);
  tma_load(s + g.off[3], r.rub, 4 * v, bar);
  tma_load(s + g.off[4], r.ep, 4 * v, bar);
  tma_load(s + g.off[5], r.wlth, 4 * v, bar);
  tma_load(s + g.off[6], r.valid, e, bar);
  tma_load(s + g.off[7], r.cutflag, v, bar);
  tma_load(s + g.off[8], r.exact, v, bar);
  tma_load(s + g.off[9], r.mask, v, bar);
  tma_load(s + g.off[10], r.wlp, v, bar);
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

// ---------------------------------------------------------------- entry point
static cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// `ptrs` is a host array of the 18 device pointers in BwdArgs order;
// `ring` holds a slot's RING_ROWS plane offsets and its size in bytes;
// `block` is B, the layers of a ring block, or 0 for the direct route
// (engine/backward.py `backward_plan` chooses both).  Returns 0 or a CUDA
// error code.
extern "C" int fused_backward(const int64_t* ptrs, const int* ring, int block, int K, int n,
                              int W, int D, void* stream) {
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

  // a thread per node slot, up to a block
  int threads = ((W + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  cudaStream_t s = (cudaStream_t)stream;
  if (block == 0) {
    const size_t smem = (size_t)16 * W;
    cudaError_t err = allow_smem((const void*)backward_direct_kernel, smem);
    if (err != cudaSuccess) return err;
    backward_direct_kernel<<<K, threads, smem, s>>>(a, n, W, D);
    return cudaGetLastError();
  }
  Ring g;
  for (int i = 0; i < RING_ROWS; ++i) g.off[i] = ring[i];
  g.bytes = ring[RING_ROWS];
  const size_t smem = (size_t)16 * W + 2 * (size_t)g.bytes + 2 * sizeof(uint64_t);
  cudaError_t err = allow_smem((const void*)backward_tma_kernel, smem);
  if (err != cudaSuccess) return err;
  backward_tma_kernel<<<K, threads, smem, s>>>(a, g, n, W, D, block);
  return cudaGetLastError();
}
