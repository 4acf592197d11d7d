// K1: per-lane lexicographic multi-key sort (ddo_tpu_torch/ops/sort.py).
//
// Replaces the Pallas kernels `_packed_sort_kernel` (behind `sort_packed`)
// and `_sort_kernel` (behind `sort_lanes`) of ddo_tpu/ops/sort_pallas.py.
// Each of L lanes sorts its C int32 rows ascending, lexicographic on the
// first `num_keys` operands; the remaining operands are payload that
// follows the rows.  Engine calls supply a unique final key, so the order
// is total and every correct sort gives one answer.
//
// Three hand-written routes, chosen by shape in the wrapper (ops/sort.py,
// `lane_sort_route`); none stands in for another's failure:
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
//  * "merge" (any C: lanes whose keys pass one block's shared memory,
//    TSPTW's 15,616 candidates with 11 keys at width 256, or a lane of
//    2^17 rows): a merge sort of row positions over several CTAs per lane,
//    in global memory.  A tile pass sorts runs of T consecutive rows, one
//    CTA each, with the "perm" network over their keys in shared memory;
//    then each merge pass doubles the run length: every thread finds where
//    its ME outputs start in the two runs by a merge-path binary search on
//    its diagonal and merges them, reading key words through L2 only until
//    a pair of rows differs (TSPTW's 11 key words mostly stop at the first
//    two).  The passes ping-pong between two int32 [L, C] workspace buffers
//    that the wrapper allocates; a last kernel gathers every operand
//    through the final positions.  The position breaks every tie, so the
//    result is the stable plain version's.  A radix sort would pay 4 byte
//    passes per key word (44 for TSPTW, 156 for SOP's 39 keys).
//
// The operands arrive by pointer and strides inside the kernel's
// parameter struct, read in place from the parameter space
// (__grid_constant__: no per-thread copy of its 3 KB); no stacked copy, no
// host-to-device copy of pointers.  The output is one contiguous int32
// [n_ops, L, C] array.
//
// What bounds it: a lane's data is read and written once (4 MB at the
// knapsack sort-1 shape of 128 x 512 rows, 8 operands: 1.25 us at
// 3.35 TB/s), and a comparison sort does C log2(C) compares per lane, a
// few int32 operations per key word each (of the same order at the card's
// int32 rate).  What "regs" and "perm" really wait on is the stage chain:
// 45 stages in series inside one CTA per lane, each a dependent
// shuffle-compare-select (or exchange-compare-select) step.  "merge"
// spreads a lane over many CTAs but reads its keys from L2 with dependent
// loads in the binary searches and the merge loop, and moves the
// positions through device memory once per pass.  Tensor cores have
// nothing to offer an integer compare/select network.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define LS_MAX_OPS 128  // ops/sort.py MAX_OPERANDS
#define LS_NK_MAX 8     // ops/sort.py REGS_MAX_KEYS
#define LS_E 2          // rows per thread on the "regs" route
#define LS_C2_MAX 2048  // ops/sort.py REGS_MAX_ROWS: 1024 threads x LS_E rows
#define KEY_PAD 0x7fffffff
#define LS_T_MAX 1024   // ops/sort.py MERGE_TILE_MAX: rows per tile of the "merge" route
#define LS_ME 8         // outputs per thread of a merge pass
#define LS_MERGE_THREADS 256

// Operand t of lane b, row c is in[t][b * rs[t] + c * cs[t]].  3,072
// bytes with 128 operands: inside the 4,096 bytes of a kernel's parameters
// beside the other arguments (static_assert below).
struct SortArgs {
  const int* in[LS_MAX_OPS];
  long long rs[LS_MAX_OPS];
  long long cs[LS_MAX_OPS];
};
static_assert(sizeof(SortArgs) + 64 <= 4096, "kernel parameters past 4 KB");

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
    lane_sort_regs_kernel(const __grid_constant__ SortArgs a, int* out, int n_ops, int L, int C,
                          int C2) {
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

__global__ void lane_sort_perm_kernel(const __grid_constant__ SortArgs a, int* out, int n_ops,
                                      int num_keys, int L, int C, int C2) {
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


// ------------------------------------------------------------ route "merge"
// Row x < row y of lane b in (key_0, ..., key_{nk-1}, position) order,
// the keys read through the read-only path until they differ.
__device__ __forceinline__ bool merge_less(const SortArgs& a, int nk, long long b, int x, int y) {
  for (int t = 0; t < nk; ++t) {
    const int* p = a.in[t] + b * a.rs[t];
    const long long cs = a.cs[t];
    const int u = __ldg(p + x * cs), v = __ldg(p + y * cs);
    if (u != v) return u < v;
  }
  return x < y;
}

// Tile pass, grid (ceil(C / T), L): rows [base, base + T) of lane b sorted
// by the "perm" network over their keys in shared memory, pads (local
// index >= n) last; the sorted positions go to ws[b, base : base + n].
__global__ void merge_tile_kernel(const __grid_constant__ SortArgs a, int* ws, int nk, int C,
                                  int T) {
  extern __shared__ int smem[];
  int* perm = smem;      // [T] local indices
  int* keys = smem + T;  // [nk][T]
  const long long b = blockIdx.y;
  const int base = blockIdx.x * T;
  const int n = min(T, C - base);
  for (int c = threadIdx.x; c < T; c += blockDim.x) {
    perm[c] = c;
    if (c < n)
      for (int t = 0; t < nk; ++t) keys[t * T + c] = load_op(a, t, b, base + c);
  }
  __syncthreads();
  for (int k = 2; k <= T; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (T >> 1); p += blockDim.x) {
        const int i = 2 * p - (p & (j - 1));  // pair (i, i + j), bit j of i clear
        const int l = i + j;
        const int x = perm[i], y = perm[l];
        // x > y in (is_pad, keys, local index) order
        bool greater;
        if (x >= n || y >= n) {
          greater = x >= n && (y < n || x > y);
        } else {
          greater = x > y;
          for (int t = 0; t < nk; ++t) {
            const int u = keys[t * T + x], v = keys[t * T + y];
            if (u != v) {
              greater = u > v;
              break;
            }
          }
        }
        if (greater == ((i & k) == 0)) {
          perm[i] = y;
          perm[l] = x;
        }
      }
      __syncthreads();
    }
  }
  int* dst = ws + b * C + base;
  for (int c = threadIdx.x; c < n; c += blockDim.x) dst[c] = base + perm[c];
}

// Merge pass, grid (ceil(C / (LS_ME * blockDim)), L): runs [s, s + R) and
// [s + R, s + 2R) of src merged into dst[s, s + 2R), each thread writing
// LS_ME consecutive outputs (2R is a multiple of LS_ME, so they never
// straddle two pairs of runs).  The run over [s, s + R) holds exactly the
// rows at positions s..s+R-1, so ties (impossible: positions differ) would
// keep the left run first anyway.
__global__ void merge_pass_kernel(const __grid_constant__ SortArgs a, const int* src, int* dst,
                                  int nk, int C, long long R) {
  const long long b = blockIdx.y;
  const long long g0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * LS_ME;
  if (g0 >= C) return;
  const long long s = g0 / (2 * R) * (2 * R);
  const long long mid = min(s + R, (long long)C), end = min(s + 2 * R, (long long)C);
  const int lenA = (int)(mid - s), lenB = (int)(end - mid);
  const int* A = src + b * C + s;
  const int* B = src + b * C + mid;
  // merge path: i outputs of A among the first d of the pair
  const int d = (int)(g0 - s);
  int lo = max(0, d - lenB), hi = min(d, lenA);
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (merge_less(a, nk, b, A[m], B[d - m - 1]))
      lo = m + 1;
    else
      hi = m;
  }
  int i = lo, j = d - lo;
  int* out = dst + b * C;
  const long long stop = min(g0 + LS_ME, end);
  for (long long g = g0; g < stop; ++g) {
    const bool takeA = j >= lenB || (i < lenA && merge_less(a, nk, b, A[i], B[j]));
    out[g] = takeA ? A[i++] : B[j++];
  }
}

// Gather, grid (ceil(C / blockDim), L): out[t, b, c] = operand t at row
// perm[b, c] of lane b, for every operand.
__global__ void merge_gather_kernel(const __grid_constant__ SortArgs a, const int* perm,
                                    int* out, int n_ops, int L, int C) {
  const long long b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int p = perm[b * C + c];
  const size_t plane = (size_t)L * C;
  for (int t = 0; t < n_ops; ++t) out[t * plane + b * C + c] = load_op(a, t, b, p);
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

// The "merge" route's tile: the most rows (a power of two, at most
// LS_T_MAX, at least 256) whose keys and permutation fit 100 KB of shared
// memory, so that two tile CTAs share an SM (ops/sort.py merge_tile).
static int merge_tile(int num_keys) {
  int T = LS_T_MAX;
  while (T > 256 && (size_t)(num_keys + 1) * T * sizeof(int) > 100 * 1024) T >>= 1;
  return T;
}

// Route "merge", the same arguments and `ws`, an int32 [2, L, C] device
// workspace.  Returns 0, a CUDA error code, -2 as above, or -3 when L
// exceeds the grid's 65,535 lanes.
extern "C" int lane_sort_merge(const SortArgs* a, int* out, int* ws, int n_ops, int num_keys,
                               int L, int C, void* stream) {
  if (n_ops > LS_MAX_OPS || num_keys < 1 || num_keys > n_ops) return -2;
  if (L > 65535) return -3;
  cudaStream_t s = (cudaStream_t)stream;
  const int T = merge_tile(num_keys);
  const size_t smem = (size_t)(num_keys + 1) * T * sizeof(int);
  cudaError_t err = allow_smem((const void*)merge_tile_kernel, smem);
  if (err != cudaSuccess) return err;
  merge_tile_kernel<<<dim3((C + T - 1) / T, L), T / 2, smem, s>>>(*a, ws, num_keys, C, T);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  int* src = ws;
  int* dst = ws + (size_t)L * C;
  const long long per_block = (long long)LS_ME * LS_MERGE_THREADS;
  for (long long R = T; R < C; R <<= 1) {
    merge_pass_kernel<<<dim3((unsigned)((C + per_block - 1) / per_block), L), LS_MERGE_THREADS, 0,
                        s>>>(*a, src, dst, num_keys, C, R);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    int* t = src;
    src = dst;
    dst = t;
  }
  merge_gather_kernel<<<dim3((C + 255) / 256, L), 256, 0, s>>>(*a, src, out, n_ops, L, C);
  return cudaGetLastError();
}
