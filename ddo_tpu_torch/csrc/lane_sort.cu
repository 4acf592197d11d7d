// K1: per-lane lexicographic multi-key sort (ddo_tpu_torch/ops/sort.py).
//
// Replaces the Pallas kernels `_packed_sort_kernel` (behind `sort_packed`)
// and `_sort_kernel` (behind `sort_lanes`) of ddo_tpu/ops/sort_pallas.py.
// Each of L lanes sorts its C int32 rows ascending, lexicographic on the
// first `num_keys` operands; the remaining operands are payload that
// follows the rows.  Engine calls supply a unique final key, so the order
// is total and every correct sort gives one answer.
//
// Two hand-written routes, chosen by shape in the wrapper (ops/sort.py,
// `lane_sort_route`); neither stands in for the other's failure:
//
//  * "regs" (num_keys <= LS_NK_MAX, C2 = C padded to a power of two
//    <= LS_C2_MAX): a bitonic network held in registers.  One CTA sorts
//    one lane; each of its C2/2 threads holds LS_E = 2 rows (their key
//    words and original positions) at positions 2*tid and 2*tid+1.  A
//    stage of partner distance j runs in registers for j = 1, through
//    __shfl_xor_sync inside the warp for 2 <= j < 64, and through a
//    shared-memory exchange with one barrier (double-buffered) for
//    j >= 64: 9, 30 and 6 of the 45 stages at C2 = 512.  (Four or eight
//    rows per thread move data in fewer stages but leave fewer warps to
//    hide each stage's dependent shuffle-compare-select chain.)  A compare
//    is the borrow of one multi-word subtraction over the keys biased to
//    unsigned order, then the position: the order is total even with
//    tied keys (the sort is stable, like the plain version), and pad rows
//    (position >= C, every key 2^31-1) sort after every real row, a real
//    key of 2^31-1 included.  The keys are read with independent loads
//    issued before the first stage and written out from registers; each
//    payload operand is gathered once through the final positions.
//  * "perm" (more keys, or C2 up to what shared memory holds): the
//    earlier design.  The keys go to shared memory and a bitonic network
//    sorts an index permutation there, one __syncthreads per stage; keys
//    and payloads are then gathered through it.  Unstable on ties.
//
// The operands arrive by pointer and strides inside the kernel's
// parameter struct (no stacked copy, no host-to-device copy of
// pointers); the output is one contiguous int32 [n_ops, L, C] array.
//
// What bounds it: a lane's data is read and written once (4 MB at the
// knapsack sort-1 shape of 128 x 512 rows, 8 operands: 1.25 us at
// 3.35 TB/s), and its network is 11,520 compare-exchanges at C2 = 512,
// a few int32 operations per key word each (of the same order at the
// card's int32 rate).  What it really waits on is the stage chain: 45
// stages in series inside one CTA per lane, each a dependent
// shuffle-compare-select (or exchange-compare-select) step, with the
// SM's shuffle rate shared by every warp of the lane.  Tensor cores have
// nothing to offer an integer compare/select network.  C beyond shared memory
// (LCS, C ~ 28k) needs a multi-pass radix sort; the wrapper raises there.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define LS_MAX_OPS 64   // ops/sort.py MAX_OPERANDS
#define LS_NK_MAX 8     // ops/sort.py REGS_MAX_KEYS
#define LS_E 2          // rows per thread on the "regs" route
#define LS_C2_MAX 2048  // ops/sort.py REGS_MAX_ROWS: 1024 threads x LS_E rows
#define KEY_PAD 0x7fffffff

// Operand t of lane b, row c is in[t][b * rs[t] + c * cs[t]].
struct SortArgs {
  const int* in[LS_MAX_OPS];
  long long rs[LS_MAX_OPS];
  long long cs[LS_MAX_OPS];
};

__device__ __forceinline__ int load_op(const SortArgs& a, int t, long long b, long long c) {
  return a.in[t][b * a.rs[t] + c * a.cs[t]];
}

// ------------------------------------------------------------- route "regs"
// A row's words are unsigned: each key biased by 2^31 (so that unsigned
// order is int32 order), then its original position i (>= C for a pad).
template <int NK>
struct Row {
  unsigned k[NK];
  unsigned i;
};

#define SIGN 0x80000000u

// a < b in (k_0, ..., k_{NK-1}, i) order: the borrow out of the
// multi-word subtraction a - b, least significant word (i) first, in one
// carry chain of NK + 2 instructions.
template <int NK>
__device__ __forceinline__ bool row_less(const Row<NK>& a, const Row<NK>& b);

#define LS_HEAD "{\n\t.reg .u32 t;\n\tsub.cc.u32 t, %1, %2;\n\t"
#define LS_STEP(x, y) "subc.cc.u32 t, %" #x ", %" #y ";\n\t"
#define LS_TAIL "subc.u32 %0, t, t;\n\t}"
#define LS_S1 LS_STEP(3, 4)
#define LS_S2 LS_S1 LS_STEP(5, 6)
#define LS_S3 LS_S2 LS_STEP(7, 8)
#define LS_S4 LS_S3 LS_STEP(9, 10)
#define LS_S5 LS_S4 LS_STEP(11, 12)
#define LS_S6 LS_S5 LS_STEP(13, 14)
#define LS_S7 LS_S6 LS_STEP(15, 16)
#define LS_S8 LS_S7 LS_STEP(17, 18)
#define LS_W(t) "r"(a.k[t]), "r"(b.k[t])
#define LS_O1 LS_W(0)
#define LS_O2 LS_W(1), LS_O1
#define LS_O3 LS_W(2), LS_O2
#define LS_O4 LS_W(3), LS_O3
#define LS_O5 LS_W(4), LS_O4
#define LS_O6 LS_W(5), LS_O5
#define LS_O7 LS_W(6), LS_O6
#define LS_O8 LS_W(7), LS_O7
#define LS_LESS(n)                                                                      \
  template <>                                                                           \
  __device__ __forceinline__ bool row_less<n>(const Row<n>& a, const Row<n>& b) {      \
    unsigned d;                                                                         \
    asm(LS_HEAD LS_S##n LS_TAIL : "=r"(d) : "r"(a.i), "r"(b.i), LS_O##n);              \
    return d != 0;                                                                      \
  }
LS_LESS(1)
LS_LESS(2)
LS_LESS(3)
LS_LESS(4)
LS_LESS(5)
LS_LESS(6)
LS_LESS(7)
LS_LESS(8)

template <int NK>
__device__ __forceinline__ void take_if(Row<NK>& self, const Row<NK>& other, bool take) {
#pragma unroll
  for (int t = 0; t < NK; ++t) self.k[t] = take ? other.k[t] : self.k[t];
  self.i = take ? other.i : self.i;
}

// Whether the row at `pos` keeps the smaller of itself and its partner
// pos ^ j in the merge of block size k.
__device__ __forceinline__ bool keeps_min(int pos, int k, int j) {
  return ((pos & k) == 0) == ((pos & j) == 0);
}

// The stage of partner distance 1: both rows of the pair are this
// thread's, the lower one r[0].
static_assert(LS_E == 2, "one in-thread stage: rows 2*tid and 2*tid+1");
template <int NK>
__device__ __forceinline__ void pair_stage(Row<NK> (&r)[LS_E], int tid, int k) {
  const bool swap = row_less(r[1], r[0]) == (((LS_E * tid) & k) == 0);
  const Row<NK> lo = r[0];
  take_if(r[0], r[1], swap);
  take_if(r[1], lo, swap);
}

template <int NK>
__global__ void __launch_bounds__(LS_C2_MAX / LS_E)
    lane_sort_regs_kernel(SortArgs a, int* out, int n_ops, int L, int C, int C2) {
  // two exchange buffers; word t of row LS_E*u+e at x[t*C2 + e*T + u]
  extern __shared__ unsigned xs[];
  const int T = blockDim.x;  // C2 / LS_E
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;

  Row<NK> r[LS_E];
#pragma unroll
  for (int e = 0; e < LS_E; ++e) {
    const int pos = LS_E * tid + e;
    r[e].i = pos;
#pragma unroll
    for (int t = 0; t < NK; ++t)
      r[e].k[t] = pos < C ? (unsigned)load_op(a, t, b, pos) ^ SIGN : 0xffffffffu;
  }

  int buf = 0;
  for (int k = 2; k <= C2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 1) {
        pair_stage(r, tid, k);
        continue;
      }
      // the partner rows are in thread tid ^ (j / LS_E), at the same e;
      // all of this thread's rows keep the same side
      const bool keep_min = keeps_min(LS_E * tid, k, j);
      const int u = tid ^ (j / LS_E);
      if (j < 32 * LS_E) {
#pragma unroll
        for (int e = 0; e < LS_E; ++e) {
          Row<NK> p;
#pragma unroll
          for (int t = 0; t < NK; ++t)
            p.k[t] = __shfl_xor_sync(0xffffffffu, r[e].k[t], j / LS_E);
          p.i = __shfl_xor_sync(0xffffffffu, r[e].i, j / LS_E);
          take_if(r[e], p, row_less(p, r[e]) == keep_min);
        }
      } else {
        // double-buffered: the last reads of this buffer were two
        // exchanges ago, before the previous exchange's barrier
        unsigned* x = xs + buf * (NK + 1) * C2;
#pragma unroll
        for (int e = 0; e < LS_E; ++e) {
#pragma unroll
          for (int t = 0; t < NK; ++t) x[t * C2 + e * T + tid] = r[e].k[t];
          x[NK * C2 + e * T + tid] = r[e].i;
        }
        __syncthreads();
#pragma unroll
        for (int e = 0; e < LS_E; ++e) {
          Row<NK> p;
#pragma unroll
          for (int t = 0; t < NK; ++t) p.k[t] = x[t * C2 + e * T + u];
          p.i = x[NK * C2 + e * T + u];
          take_if(r[e], p, row_less(p, r[e]) == keep_min);
        }
        buf ^= 1;
      }
    }
  }

  const size_t plane = (size_t)L * C;
#pragma unroll
  for (int e = 0; e < LS_E; ++e) {
    const int pos = LS_E * tid + e;
    if (pos < C) {
#pragma unroll
      for (int t = 0; t < NK; ++t) out[t * plane + b * C + pos] = (int)(r[e].k[t] ^ SIGN);
    }
  }
  // payloads: one gather each through the final positions
#pragma unroll 2
  for (int t = NK; t < n_ops; ++t) {
    const int* src = a.in[t] + b * a.rs[t];
    const long long cs = a.cs[t];
#pragma unroll
    for (int e = 0; e < LS_E; ++e) {
      const int pos = LS_E * tid + e;
      if (pos < C) out[t * plane + b * C + pos] = src[r[e].i * cs];
    }
  }
}

// ------------------------------------------------------------- route "perm"
// row a > row b in (is_pad, key_0, ..., key_{nk-1}) order
__device__ __forceinline__ bool perm_greater(const int* keys, int C, int C2, int nk, int a,
                                             int b) {
  const bool pa = a >= C, pb = b >= C;
  if (pa != pb) return pa;
  for (int t = 0; t < nk; ++t) {
    const int x = keys[t * C2 + a], y = keys[t * C2 + b];
    if (x != y) return x > y;
  }
  return false;
}

__global__ void lane_sort_perm_kernel(SortArgs a, int* out, int n_ops, int num_keys, int L,
                                      int C, int C2) {
  extern __shared__ int smem[];
  int* keys = smem;                  // [num_keys][C2]
  int* perm = smem + num_keys * C2;  // [C2]
  const long long b = blockIdx.x;

  for (int c = threadIdx.x; c < C2; c += blockDim.x) {
    perm[c] = c;
    for (int t = 0; t < num_keys; ++t)
      keys[t * C2 + c] = c < C ? load_op(a, t, b, c) : (t == 0 ? KEY_PAD : 0);
  }
  __syncthreads();

  for (int k = 2; k <= C2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (C2 >> 1); p += blockDim.x) {
        const int i = 2 * p - (p & (j - 1));  // pair (i, i + j), bit j of i clear
        const int l = i + j;
        const int x = perm[i], y = perm[l];
        const bool ascending = (i & k) == 0;
        const bool swap = ascending ? perm_greater(keys, C, C2, num_keys, x, y)
                                    : perm_greater(keys, C, C2, num_keys, y, x);
        if (swap) {
          perm[i] = y;
          perm[l] = x;
        }
      }
      __syncthreads();
    }
  }

  const size_t plane = (size_t)L * C;
  for (int t = 0; t < n_ops; ++t)
    for (int c = threadIdx.x; c < C; c += blockDim.x)
      out[t * plane + b * C + c] = load_op(a, t, b, perm[c]);
}

// ------------------------------------------------------------- entry points
static int pow2_at_least(int c, int floor) {
  int c2 = floor;
  while (c2 < c) c2 <<= 1;
  return c2;
}

static cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int NK>
static int launch_regs(const SortArgs& a, int* out, int n_ops, int L, int C, int C2,
                       cudaStream_t stream) {
  const size_t smem = (size_t)2 * (NK + 1) * C2 * sizeof(unsigned);
  cudaError_t err = allow_smem((const void*)lane_sort_regs_kernel<NK>, smem);
  if (err != cudaSuccess) return err;
  lane_sort_regs_kernel<NK><<<L, C2 / LS_E, smem, stream>>>(a, out, n_ops, L, C, C2);
  return cudaGetLastError();
}

// Route "regs".  `a` is a host struct, passed to the kernel by value; `out`
// is the contiguous int32 [n_ops, L, C] device output.  Returns 0, a CUDA
// error code, -2 when num_keys is not in [1, min(n_ops, LS_NK_MAX)] or
// n_ops exceeds LS_MAX_OPS, or -3 when C2 exceeds LS_C2_MAX.
extern "C" int lane_sort_regs(const SortArgs* a, int* out, int n_ops, int num_keys, int L,
                              int C, void* stream) {
  if (n_ops > LS_MAX_OPS || num_keys < 1 || num_keys > n_ops || num_keys > LS_NK_MAX)
    return -2;
  // at least one full warp of threads: small lanes sort more pad rows
  const int C2 = pow2_at_least(C, 32 * LS_E);
  if (C2 > LS_C2_MAX) return -3;
  cudaStream_t s = (cudaStream_t)stream;
  switch (num_keys) {
    case 1: return launch_regs<1>(*a, out, n_ops, L, C, C2, s);
    case 2: return launch_regs<2>(*a, out, n_ops, L, C, C2, s);
    case 3: return launch_regs<3>(*a, out, n_ops, L, C, C2, s);
    case 4: return launch_regs<4>(*a, out, n_ops, L, C, C2, s);
    case 5: return launch_regs<5>(*a, out, n_ops, L, C, C2, s);
    case 6: return launch_regs<6>(*a, out, n_ops, L, C, C2, s);
    case 7: return launch_regs<7>(*a, out, n_ops, L, C, C2, s);
    default: return launch_regs<8>(*a, out, n_ops, L, C, C2, s);
  }
}

// Route "perm", same arguments.  Returns 0, a CUDA error code, or -2 as
// above (without the key limit); a lane too large for shared memory makes
// the launch fail with a CUDA error.
extern "C" int lane_sort_perm(const SortArgs* a, int* out, int n_ops, int num_keys, int L,
                              int C, void* stream) {
  if (n_ops > LS_MAX_OPS || num_keys < 1 || num_keys > n_ops) return -2;
  const int C2 = pow2_at_least(C, 2);
  const size_t smem = (size_t)(num_keys + 1) * C2 * sizeof(int);
  cudaError_t err = allow_smem((const void*)lane_sort_perm_kernel, smem);
  if (err != cudaSuccess) return err;
  int threads = C2 >> 1;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  lane_sort_perm_kernel<<<L, threads, smem, (cudaStream_t)stream>>>(*a, out, n_ops, num_keys,
                                                                     L, C, C2);
  return cudaGetLastError();
}
