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
// What bounds it: the n-step serial dependency (layer l needs layer l+1's
// carries) and the device-memory latency of each layer's edge and node
// loads, more than bandwidth: at K=128, n=2000, W=256, D=2 the sweep
// reads ~2.5 GB and writes ~0.65 GB once, which the card's 3.35 TB/s
// would move in under 1 ms.  K = 128 CTAs fill 128 of the H100's 132 SMs.

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

// saturating int32 arithmetic; the sum wraps first, exactly like XLA's
// int32 add followed by the clip in utils/num.py
__device__ __forceinline__ int sat(int s) { return min(max(s, NEG_INF_), INF_); }
__device__ __forceinline__ int sat_add(int a, int b) {
  return sat((int)((unsigned)a + (unsigned)b));
}
__device__ __forceinline__ int sat_sub(int a, int b) {
  return sat((int)((unsigned)a - (unsigned)b));
}

__global__ void backward_kernel(BwdArgs a, int n, int W, int D) {
  extern __shared__ int sm[];
  int* vb_buf = sm;       // [2][W]
  int* th_buf = sm + 2 * W;  // [2][W]
  const int k = blockIdx.x;
  const int C = W * D;
  const int bk = a.best_known[k];

  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    vb_buf[w] = a.vb_init[(size_t)k * W + w];
    th_buf[w] = a.th_init[(size_t)k * W + w];
  }
  __syncthreads();

  int cur = 0;
  for (int l = n - 1; l >= 0; --l) {
    const int* vbc = vb_buf + cur * W;
    const int* thc = th_buf + cur * W;
    int* vbn = vb_buf + (1 - cur) * W;
    int* thn = th_buf + (1 - cur) * W;
    const size_t node0 = ((size_t)k * n + l) * W;
    const size_t edge0 = ((size_t)k * n + l) * C;
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      // local bounds and child thresholds over the node's D out-edges
      int vb_l = NEG_INF_, th_l = INF_;
      bool mk = false, hs = false;
      for (int d = 0; d < D; ++d) {
        const size_t e = edge0 + (size_t)w * D + d;
        const int ec = a.child[e];
        const int eco = a.cost[e];
        const bool ok = a.valid[e] && ec >= 0;
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
      const size_t i = node0 + w;
      // theta of filter-pruned children that never materialized
      const int ep = a.ep_theta[i];
      th_l = min(th_l, ep);
      hs = hs || ep < INF_;
      if (!hs) th_l = INF_;

      // thresh_rules (backward.py:42-55, clean.rs:503-517)
      const bool alive = a.mask[i];
      const int val = a.val[i], rub = a.rub[i];
      const bool cutf = a.cutflag[i], ex = a.exact[i];
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
      const bool use_wl = a.wlp[i] && a.wlth[i] < INF_;
      if (use_wl) th_l = a.wlth[i];
      hs = hs || use_wl;

      a.vb_out[i] = vb_l;
      a.mk_out[i] = mk;
      a.th_out[i] = th_l;
      a.hs_out[i] = hs;
      vbn[w] = mk ? vb_l : NEG_INF_;
      thn[w] = (hs && (alive || use_wl)) ? th_l : INF_;
    }
    __syncthreads();
    cur = 1 - cur;
  }
}

// `ptrs` is a host array of the 18 device pointers in BwdArgs order.
// Returns 0, a CUDA error code, or -1 when 4*W ints exceed shared memory.
extern "C" int fused_backward(const int64_t* ptrs, int K, int n, int W, int D,
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

  const size_t smem = (size_t)4 * W * sizeof(int);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return -1;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(backward_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int threads = ((W + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  backward_kernel<<<K, threads, smem, (cudaStream_t)stream>>>(a, n, W, D);
  return cudaGetLastError();
}
