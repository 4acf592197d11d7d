// K1: per-lane lexicographic multi-key sort (ddo_tpu_torch/ops/sort.py).
//
// Replaces the Pallas kernels `_packed_sort_kernel` (behind `sort_packed`)
// and `_sort_kernel` (behind `sort_lanes`) of ddo_tpu/ops/sort_pallas.py.
// Each of L lanes sorts its C int32 rows ascending, lexicographic on the
// first `num_keys` operands; the remaining operands are payload that
// follows the rows.  Ties on every key keep the rows' order (the sort is
// stable, like the plain version), so every route gives one answer.
//
// A row is compared as a record: its key words, then its position in the
// lane.  The position ends every comparison, so the order is total.  Three
// hand-written routes, chosen by shape in the wrapper (ops/sort.py,
// `lane_sort_route`); none stands in for another's failure:
//
//  * "regs" (num_keys <= LS_NK_MAX, C2 = C padded to a power of two
//    <= LS_C2_MAX) and "perm" (more keys, C2 <= LS_PERM_C2_MAX): one
//    bitonic network held in registers, one CTA per lane
//    (`lane_sort_net_kernel<NK>`).  Each of its C2/2 threads holds LS_E = 2
//    rows as records (NK key words biased to unsigned order, then the
//    position) at positions 2*tid and 2*tid+1.  A stage of partner
//    distance j runs in registers for j = 1, through __shfl_xor_sync
//    inside the warp for 2 <= j < 64, and through a shared-memory exchange
//    with one barrier (double-buffered) for j >= 64: 9, 30 and 6 of the 45
//    stages at C2 = 512.  A compare is the borrow of one multi-word
//    subtraction over the record, in one carry chain.  "regs" holds up to
//    8 key words (1,024 threads), "perm" up to LS_P_MAX = 12 (512 threads,
//    so that 13-word records fit the registers); past 12 keys "perm"
//    carries the first 12 and stages the rest in shared memory, read only
//    when two rows tie on the 12.  Pad rows (position >= C, every word
//    0xffffffff) sort after every real row, a real key of 2^31-1 included.
//    Keys are written from registers (the staged ones from shared memory)
//    and each payload is gathered once through the final positions.
//  * "merge" (any C): a merge sort over many CTAs per lane, in records:
//    a row's first P = min(num_keys, 12) key words, then its position.  A
//    tile pass stages the key words of T consecutive rows into shared
//    memory with cp.async (coalesced, each word read once); the first two
//    words of each row form a 64-bit head, so that one compare of the
//    heads settles almost every pair.  Each thread sorts 8 rows with a
//    sorting network in registers, then log2(T / 8) levels of merge-path
//    merges sort an index permutation in shared memory, each thread
//    writing 8 outputs per level from runs whose next row and head it
//    keeps in registers.  The sorted tile goes out as records to a
//    workspace (int32 [P + 1, L, C]).  Each merge pass doubles the run
//    length: a block owns S consecutive outputs, finds where they start
//    and end in the two runs with a 32-way search by one warp over the
//    records (log32 steps, not log2 dependent loads), stages both input
//    windows into shared memory with cp.async, merges them there and
//    streams the records out in order.  The last pass (or the tile pass,
//    when one tile holds the lane) writes the key planes from the records;
//    only the other operands are gathered, by a gather pass that stages
//    each operand's lane in shared memory (coalesced) and reads it through
//    the final positions, or, for a lane past shared memory, by the last
//    pass itself.  Keys past the 12 carried words are read from the
//    operand planes, only for rows that tie on the 12.  T, S and the
//    passes come from the wrapper's plan (ops/sort.py `merge_plan`).
//
// The operands arrive by pointer and strides inside the kernel's
// parameter struct, read in place from the parameter space
// (__grid_constant__: no per-thread copy); no stacked copy, no
// host-to-device copy of pointers.  A call of at most LS_SMALL_OPS
// operands passes a 3 KB struct; more (up to LS_MAX_OPS) pass a 12 KB one,
// which Hopper takes since CUDA 12.1 (32,764 bytes of kernel parameters).
// The output is one contiguous int32 [n_ops, L, C] array.
//
// What bounds it: a lane's data is read and written once (4 MB at the
// knapsack sort-1 shape of 128 x 512 rows, 8 operands: 1.25 us at
// 3.35 TB/s), and a comparison sort does C log2(C) compares per lane, a
// few int32 operations per key word each.  What the networks wait on is
// the stage chain: 45 stages in series inside one CTA per lane, each a
// dependent shuffle-compare-select step.  "merge" moves each record
// through device memory once per pass (48 B a row at TSPTW's 11 keys),
// and its merges wait on shared-memory loads at random rows (bank
// conflicts: the tile pass's levels take most of its time).  Tensor cores
// have nothing to offer an integer compare/select network.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define LS_MAX_OPS 512       // ops/sort.py MAX_OPERANDS
#define LS_SMALL_OPS 128     // ops/sort.py SMALL_OPERANDS: the 3 KB parameter struct
#define LS_NK_MAX 8          // ops/sort.py REGS_MAX_KEYS
#define LS_P_MAX 12          // ops/sort.py PREFIX_WORDS: key words a record carries
#define LS_E 2               // rows per thread of the networks
#define LS_C2_MAX 2048       // ops/sort.py REGS_MAX_ROWS: 1024 threads x LS_E rows
#define LS_PERM_C2_MAX 1024  // ops/sort.py PERM_MAX_ROWS, past LS_NK_MAX keys
#define LS_ME 8              // outputs per thread of a merge
#define LS_T_MIN 256         // ops/sort.py MERGE_MIN_ROWS: least tile and window
#define LS_T_MAX 8192        // ops/sort.py MERGE_MAX_TILE: LS_ME x 1024 threads

// Operand t of lane b, row c is in[t][b * rs[t] + c * cs[t]].
template <int CAP>
struct SortArgs {
  const int* in[CAP];
  long long rs[CAP];
  long long cs[CAP];
};
typedef SortArgs<LS_SMALL_OPS> SmallArgs;
typedef SortArgs<LS_MAX_OPS> LargeArgs;
static_assert(sizeof(SmallArgs) + 64 <= 4096, "small kernel parameters past 4 KB");
static_assert(sizeof(LargeArgs) + 64 <= 32764, "kernel parameters past 32,764 bytes");

extern __shared__ __align__(16) unsigned char ls_smem[];

template <class A>
__device__ __forceinline__ int load_op(const A& a, int t, long long b, long long c) {
  return a.in[t][b * a.rs[t] + c * a.cs[t]];
}

// 4-byte asynchronous copy from device to shared memory, and the wait for
// every copy this thread issued.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
#else
  *(int*)dst = *(const int*)src;
#endif
}

__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;\n" ::: "memory");
#endif
}

// x < y in (key words t >= from, then position) order, rows x and y of lane
// b read from the operand planes: how a record settles a tie on its prefix.
template <class A>
__device__ __noinline__ bool tail_less(const A& a, int from, int nk, long long b, int x, int y) {
  for (int t = from; t < nk; ++t) {
    const int u = load_op(a, t, b, x), v = load_op(a, t, b, y);
    if (u != v) return u < v;
  }
  return x < y;
}

// ----------------------------------------------- routes "regs" and "perm"
// A row's words are unsigned: each key biased by 2^31 (so that unsigned
// order is int32 order), then its original position i (>= C for a pad).
template <int NK>
struct Row {
  unsigned k[NK];
  unsigned i;
};

#define SIGN 0x80000000u

#ifdef __CUDA_ARCH__
// a < b in (k_0, ..., k_{NK-1}, i) order: the borrow out of the
// multi-word subtraction a - b, least significant word (i) first, in one
// carry chain of NK + 2 instructions.
template <int NK>
__device__ __forceinline__ bool row_borrow(const Row<NK>& a, const Row<NK>& b);

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
#define LS_S9 LS_S8 LS_STEP(19, 20)
#define LS_S10 LS_S9 LS_STEP(21, 22)
#define LS_S11 LS_S10 LS_STEP(23, 24)
#define LS_S12 LS_S11 LS_STEP(25, 26)
#define LS_W(t) "r"(a.k[t]), "r"(b.k[t])
#define LS_O1 LS_W(0)
#define LS_O2 LS_W(1), LS_O1
#define LS_O3 LS_W(2), LS_O2
#define LS_O4 LS_W(3), LS_O3
#define LS_O5 LS_W(4), LS_O4
#define LS_O6 LS_W(5), LS_O5
#define LS_O7 LS_W(6), LS_O6
#define LS_O8 LS_W(7), LS_O7
#define LS_O9 LS_W(8), LS_O8
#define LS_O10 LS_W(9), LS_O9
#define LS_O11 LS_W(10), LS_O10
#define LS_O12 LS_W(11), LS_O11
#define LS_LESS(n)                                                                      \
  template <>                                                                           \
  __device__ __forceinline__ bool row_borrow<n>(const Row<n>& a, const Row<n>& b) {    \
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
LS_LESS(9)
LS_LESS(10)
LS_LESS(11)
LS_LESS(12)
#endif

template <int NK>
__device__ __forceinline__ bool row_less(const Row<NK>& a, const Row<NK>& b) {
#ifdef __CUDA_ARCH__
  return row_borrow<NK>(a, b);
#else
  for (int t = 0; t < NK; ++t)
    if (a.k[t] != b.k[t]) return a.k[t] < b.k[t];
  return a.i < b.i;
#endif
}

// a < b where key words NK.. of a lane of C rows (padded to C2) are
// staged in shared memory as int32 [ntail][C2], read only when a and b tie
// on their NK carried words.  Two rows one of which is a pad compare by
// position: the pad's is the larger.
template <int NK>
__device__ __forceinline__ bool net_less(const Row<NK>& a, const Row<NK>& b, const int* tail,
                                         int ntail, int C, int C2) {
  if (NK == LS_P_MAX && ntail) {
    bool eq = true;
#pragma unroll
    for (int t = 0; t < NK; ++t) eq &= a.k[t] == b.k[t];
    if (eq) {
      if (a.i < (unsigned)C && b.i < (unsigned)C)
        for (int t = 0; t < ntail; ++t) {
          const int u = tail[t * C2 + a.i], v = tail[t * C2 + b.i];
          if (u != v) return u < v;
        }
      return a.i < b.i;
    }
  }
  return row_less(a, b);
}

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

// The networks' threads: 1,024 up to LS_NK_MAX key words, 512 beyond.
#define LS_NET_THREADS(NK) ((NK) <= LS_NK_MAX ? LS_C2_MAX / LS_E : LS_PERM_C2_MAX / LS_E)

// One lane per CTA, C2 / LS_E threads; nk key operands of which the first
// NK = min(nk, LS_P_MAX) ride in the records and the rest (nk > LS_P_MAX)
// are staged in shared memory.
template <int NK, class A>
__global__ void __launch_bounds__(LS_NET_THREADS(NK))
    lane_sort_net_kernel(const __grid_constant__ A a, int* out, int n_ops, int nk, int L, int C,
                         int C2) {
  // two exchange buffers, word t of row LS_E*u+e at x[t*C2 + e*T + u];
  // then the staged key words
  unsigned* xs = (unsigned*)ls_smem;
  int* tail = (int*)(xs + 2 * (NK + 1) * C2);
  // key words past the record: none below LS_P_MAX, known at compile time
  const int ntail = NK == LS_P_MAX ? nk - NK : 0;
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
  if (ntail > 0) {
    for (int t = 0; t < ntail; ++t) {
      const int* src = a.in[NK + t] + b * a.rs[NK + t];
      const long long cs = a.cs[NK + t];
      for (int c = tid; c < C; c += T) cp_async4(tail + t * C2 + c, src + c * cs);
    }
    cp_async_wait_all();
    __syncthreads();
  }

  int buf = 0;
  for (int k = 2; k <= C2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 1) {
        // both rows of the pair are this thread's, the lower one r[0]
        const bool swap = net_less(r[1], r[0], tail, ntail, C, C2) == (((LS_E * tid) & k) == 0);
        const Row<NK> lo = r[0];
        take_if(r[0], r[1], swap);
        take_if(r[1], lo, swap);
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
          take_if(r[e], p, net_less(p, r[e], tail, ntail, C, C2) == keep_min);
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
          take_if(r[e], p, net_less(p, r[e], tail, ntail, C, C2) == keep_min);
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
      for (int t = 0; t < ntail; ++t) out[(NK + t) * plane + b * C + pos] = tail[t * C2 + r[e].i];
    }
  }
  // payloads: one gather each through the final positions
#pragma unroll 2
  for (int t = NK + ntail; t < n_ops; ++t) {
    const int* src = a.in[t] + b * a.rs[t];
    const long long cs = a.cs[t];
#pragma unroll
    for (int e = 0; e < LS_E; ++e) {
      const int pos = LS_E * tid + e;
      if (pos < C) out[t * plane + b * C + pos] = src[r[e].i * cs];
    }
  }
}

// ------------------------------------------------------------ route "merge"
// A record's words W[0..P]: the first P key words, then the row's position
// in the lane.  Staged in shared memory, W[0] and W[1] (the position when
// P = 1) form one 64-bit head per row: the upper half W[0], the lower
// W[1], both as int32; the others lie in planes.  Two rows compare by
// head first, one 64-bit compare of the halves biased to unsigned order,
// which settles almost every compare; a tie on the head goes on through
// W[2..P-1], the key words past P (from the operand planes), the position.
#define HEAD_BIAS 0x8000000080000000ull

__device__ __forceinline__ unsigned long long head_key(const unsigned long long* head, int x) {
  return head[x] ^ HEAD_BIAS;
}

// Record word w (0 or 1) of row x inside its head: W[0] the upper half,
// W[1] the lower.
__device__ __forceinline__ int* head_word(unsigned long long* head, int x, int w) {
  return (int*)(head + x) + (1 - w);
}

// Outputs [d, e) of the merge of two sorted runs, A = items 0..lenA-1 and
// B = items lenA..lenA+lenB-1 (0 <= d <= e <= lenA + lenB): a merge-path
// binary search on diagonal d, then e - d steps that keep the next row of
// each run and its head in registers.  item(k) is the row of item k,
// head(x) its biased head, tie(x, y) orders rows whose heads are equal;
// the order is total (no two rows tie), and emit(g, x) receives output g.
template <class Item, class Head, class Tie, class Emit>
__device__ __forceinline__ void merge_run(int lenA, int lenB, int d, int e, Item item, Head head,
                                          Tie tie, Emit emit) {
  auto less = [&](int x, unsigned long long hx, int y, unsigned long long hy) {
    return hx != hy ? hx < hy : tie(x, y);
  };
  int lo = max(0, d - lenB), hi = min(d, lenA);
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    const int x = item(m), y = item(lenA + d - m - 1);
    if (less(x, head(x), y, head(y)))
      lo = m + 1;
    else
      hi = m;
  }
  int i = lo, j = d - lo, xa = 0, xb = 0;
  unsigned long long ha = 0, hb = 0;
  if (i < lenA) ha = head(xa = item(i));
  if (j < lenB) hb = head(xb = item(lenA + j));
  for (int g = d; g < e; ++g) {
    if (j >= lenB || (i < lenA && less(xa, ha, xb, hb))) {
      emit(g, xa);
      if (++i < lenA) ha = head(xa = item(i));
    } else {
      emit(g, xb);
      if (++j < lenB) hb = head(xb = item(lenA + j));
    }
  }
}

// out[t * LC + o + c] = operand t of lane b at row pos(c), for operands
// t = from .. n_ops-1 and outputs c < n: the (t, c) pairs spread over the
// threads, with LS_G loads in flight per thread (out may alias the
// operands as far as the compiler knows, so it would not hoist a load
// above the store before it), so that a few rows of many operands are
// fetched as fast as many rows of a few.
#define LS_G 8
template <class A, class Pos>
__device__ __forceinline__ void gather_ops(const A& a, int from, int n_ops, long long b, int* out,
                                           size_t LC, long long o, int n, int tid, int NT,
                                           Pos pos) {
  const long long total = (long long)(n_ops - from) * n;
  for (long long k0 = tid; k0 < total; k0 += (long long)LS_G * NT) {
    int v[LS_G];
#pragma unroll
    for (int q = 0; q < LS_G; ++q) {
      const long long k = k0 + (long long)q * NT;
      if (k < total) {
        const int t = from + (int)(k / n), c = (int)(k % n);
        v[q] = __ldg(a.in[t] + b * a.rs[t] + pos(c) * a.cs[t]);
      }
    }
#pragma unroll
    for (int q = 0; q < LS_G; ++q) {
      const long long k = k0 + (long long)q * NT;
      if (k < total) out[(from + k / n) * LC + o + k % n] = v[q];
    }
  }
}

// Tile pass, a 1-D grid of L x tiles blocks: rows [base, base + n) of lane
// b, n = min(T, C - base).  Their record words go to shared memory with
// cp.async (heads [T], then planes W[2..P-1] as int32 [P - 2][T]; a row's
// position is its local index), each thread sorts LS_ME rows with a
// network in registers, log2(T / LS_ME) levels of merges sort an index
// permutation (two [T] buffers), and the tile goes out as records to ws
// (int32 [P + 1, L, C]) or, when one tile holds the lane, as the final
// output.
template <class A>
__global__ void __launch_bounds__(LS_T_MAX / LS_ME)
    merge_tile_kernel(const __grid_constant__ A a, int* ws, int* out, int n_ops, int nk, int P,
                      int L, int C, int T, int tiles) {
  unsigned long long* head = (unsigned long long*)ls_smem;
  int* words = (int*)(head + T);                                       // W[2..P-1]
  unsigned short* ix = (unsigned short*)(words + (size_t)max(P - 2, 0) * T);  // 2 x [T]
  const long long b = blockIdx.x / tiles;
  const int base = (int)(blockIdx.x % tiles) * T;
  const int n = min(T, C - base);
  const int NT = blockDim.x, tid = threadIdx.x;

  for (int t = 0; t < P; ++t) {
    const int* src = a.in[t] + b * a.rs[t];
    const long long cs = a.cs[t];
    for (int c = tid; c < n; c += NT)
      cp_async4(t < 2 ? (void*)head_word(head, c, t) : (void*)(words + (t - 2) * T + c),
                src + (base + c) * cs);
  }
  if (P == 1)
    for (int c = tid; c < n; c += NT) *head_word(head, c, 1) = c;
  cp_async_wait_all();
  __syncthreads();

  // rows x, y of the tile (x != y) with equal heads: W[2..P-1], the key
  // words past P, the local index
  auto tie = [&](int x, int y) -> bool {
    for (int t = 2; t < P; ++t) {
      const int u = words[(t - 2) * T + x], v = words[(t - 2) * T + y];
      if (u != v) return u < v;
    }
    return P < nk ? tail_less(a, P, nk, b, base + x, base + y) : x < y;
  };
  auto hd = [&](int x) { return head_key(head, x); };

  // each thread's LS_ME rows sorted in registers; rows past n sort last
  {
    int x[LS_ME];
    unsigned long long h[LS_ME];
#pragma unroll
    for (int q = 0; q < LS_ME; ++q) {
      x[q] = tid * LS_ME + q;
      h[q] = x[q] < n ? hd(x[q]) : ~0ull;
    }
    // the 19 compare-exchanges of an optimal sorting network on 8 items
#define LS_CX(p, q)                                                                           \
  {                                                                                           \
    const bool swap =                                                                         \
        h[q] != h[p] ? h[q] < h[p] : (x[q] < n && (x[p] >= n || tie(x[q], x[p])));           \
    const int tx = x[p];                                                                      \
    const unsigned long long th = h[p];                                                       \
    x[p] = swap ? x[q] : x[p];                                                                \
    h[p] = swap ? h[q] : h[p];                                                                \
    x[q] = swap ? tx : x[q];                                                                  \
    h[q] = swap ? th : h[q];                                                                  \
  }
    static_assert(LS_ME == 8, "the network sorts 8 rows");
    LS_CX(0, 1) LS_CX(2, 3) LS_CX(4, 5) LS_CX(6, 7) LS_CX(0, 2) LS_CX(1, 3) LS_CX(4, 6)
    LS_CX(5, 7) LS_CX(1, 2) LS_CX(5, 6) LS_CX(0, 4) LS_CX(3, 7) LS_CX(1, 5) LS_CX(2, 6)
    LS_CX(1, 4) LS_CX(3, 6) LS_CX(2, 4) LS_CX(3, 5) LS_CX(3, 4)
#undef LS_CX
#pragma unroll
    for (int q = 0; q < LS_ME; ++q)
      if (tid * LS_ME + q < n) ix[tid * LS_ME + q] = (unsigned short)x[q];
  }
  __syncthreads();

  // levels of run length r: runs [s, s + r) and [s + r, s + 2r) of src
  // merged into dst; thread tid writes outputs [tid * LS_ME, + LS_ME)
  unsigned short* src = ix;
  unsigned short* dst = ix + T;
  for (int r = LS_ME; r < n; r <<= 1) {
    const int g = tid * LS_ME;
    if (g < n) {
      const int s = g & ~(2 * r - 1);
      const int lenA = min(r, n - s), lenB = max(0, min(2 * r, n - s) - r);
      const unsigned short* run = src + s;
      merge_run(
          lenA, lenB, g - s, min(g + LS_ME, n) - s, [&](int k) { return (int)run[k]; }, hd, tie,
          [&](int o, int x) { dst[s + o] = (unsigned short)x; });
    }
    __syncthreads();
    unsigned short* t = src;
    src = dst;
    dst = t;
  }

  const size_t LC = (size_t)L * C;
  int* to = tiles == 1 ? out : ws;
  for (int c = tid; c < n; c += NT) {
    const int x = src[c];
    const long long o = b * C + base + c;
    for (int t = 0; t < P; ++t)
      to[t * LC + o] = t < 2 ? *head_word(head, x, t) : words[(t - 2) * T + x];
    if (tiles > 1) ws[P * LC + o] = base + x;
  }
  if (tiles == 1)
    gather_ops(a, P, n_ops, b, out, LC, b * C, n, tid, NT, [&](int c) { return (int)src[c]; });
}

// Merge pass, a 1-D grid of L x chunks blocks: the runs [s, s + R) and
// [s + R, s + 2R) of src (records, int32 [P + 1, L, C]) merged into
// outputs [o0, o0 + S) of lane b, to dst as records or, on the last pass,
// to out as the sorted operands.  S divides 2R, so a block's outputs lie
// in one pair of runs.  Shared memory: the two input windows (A's, then
// B's) as heads [S] and planes W[2..P] [P - 1][S], the merged order [S]
// and the two splits.
template <class A>
__global__ void __launch_bounds__(LS_T_MAX / LS_ME)
    merge_pass_kernel(const __grid_constant__ A a, const int* src, int* dst, int* out, int n_ops,
                      int nk, int P, int L, int C, long long R, int S, int chunks, int last) {
  unsigned long long* head = (unsigned long long*)ls_smem;
  int* words = (int*)(head + S);                                   // W[2..P]
  unsigned short* ix = (unsigned short*)(words + (size_t)(P - 1) * S);
  int* split = (int*)(ix + S);
  const int NT = blockDim.x, tid = threadIdx.x;
  const long long b = blockIdx.x / chunks;
  const long long o0 = (long long)(blockIdx.x % chunks) * S;
  const long long o1 = min(o0 + S, (long long)C);
  const long long s = o0 / (2 * R) * (2 * R);
  const long long mid = min(s + R, (long long)C), end = min(s + 2 * R, (long long)C);
  const int lenA = (int)(mid - s), lenB = (int)(end - mid);
  const size_t LC = (size_t)L * C;
  const int* lane = src + b * C;

  // records p < q of the lane in src: every carried word loaded at once
  auto gless = [&](long long p, long long q) -> bool {
    int u[LS_P_MAX], v[LS_P_MAX];
#pragma unroll
    for (int t = 0; t < LS_P_MAX; ++t)
      if (t < P) {
        u[t] = __ldg(lane + t * LC + p);
        v[t] = __ldg(lane + t * LC + q);
      }
#pragma unroll
    for (int t = 0; t < LS_P_MAX; ++t)
      if (t < P && u[t] != v[t]) return u[t] < v[t];
    const int x = __ldg(lane + P * LC + p), y = __ldg(lane + P * LC + q);
    return P < nk ? tail_less(a, P, nk, b, x, y) : x < y;
  };
  // the block's first and last diagonals: the merge path's split (outputs
  // taken from A) by a 32-way search of one warp each; f(m) = A[m] <
  // B[d - m - 1] holds exactly for m below the split
  const int warp = tid >> 5, lane_id = tid & 31;
  for (int q = warp; q < 2; q += NT >> 5) {
    const long long d = (q ? o1 : o0) - s;
    int lo = (int)max(0LL, d - lenB), hi = (int)min(d, (long long)lenA);
    while (lo < hi) {
      const int m = lo + (int)(((long long)(hi - lo) * lane_id) >> 5);
      const unsigned ones = __ballot_sync(0xffffffffu, gless(s + m, mid + d - m - 1));
      const int cnt = __popc(ones);
      const int below = __shfl_sync(0xffffffffu, m, cnt > 0 ? cnt - 1 : 0);
      const int above = __shfl_sync(0xffffffffu, m, cnt < 32 ? cnt : 31);
      if (cnt > 0) lo = below + 1;
      if (cnt < 32) hi = above;
    }
    if (lane_id == 0) split[q] = lo;
  }
  __syncthreads();
  const int m0 = split[0], m1 = split[1];
  const long long d0 = o0 - s, d1 = o1 - s;
  const int la = m1 - m0, lb = (int)((d1 - m1) - (d0 - m0));
  const long long a0 = s + m0, b0 = mid + (d0 - m0);
  for (int w = 0; w <= P; ++w) {
    const int* pl = lane + w * LC;
    for (int c = tid; c < la + lb; c += NT)
      cp_async4(w < 2 ? (void*)head_word(head, c, w) : (void*)(words + (w - 2) * S + c),
                pl + (c < la ? a0 + c : b0 + c - la));
  }
  cp_async_wait_all();
  __syncthreads();

  // window rows x != y with equal heads: W[2..P-1], the key words past P,
  // the positions
  auto pos = [&](int x) { return P == 1 ? *head_word(head, x, 1) : words[(P - 2) * S + x]; };
  auto tie = [&](int x, int y) -> bool {
    for (int t = 2; t < P; ++t) {
      const int u = words[(t - 2) * S + x], v = words[(t - 2) * S + y];
      if (u != v) return u < v;
    }
    return P < nk ? tail_less(a, P, nk, b, pos(x), pos(y)) : pos(x) < pos(y);
  };
  const int n = la + lb;
  const int g = tid * LS_ME;
  if (g < n)
    merge_run(
        la, lb, g, min(g + LS_ME, n), [](int k) { return k; },
        [&](int x) { return head_key(head, x); }, tie,
        [&](int o, int x) { ix[o] = (unsigned short)x; });
  __syncthreads();

  // records to dst; on the last pass the key words to out, then the
  // other operands gathered here (last == 1) or the positions left in
  // dst's position plane for merge_gather_kernel (last == 2)
  int* to = last ? out : dst;
  for (int c = tid; c < n; c += NT) {
    const int x = ix[c];
    const long long o = b * C + o0 + c;
    for (int w = 0; w < P; ++w)
      to[w * LC + o] = w < 2 ? *head_word(head, x, w) : words[(w - 2) * S + x];
    if (last != 1) dst[P * LC + o] = pos(x);
  }
  if (last == 1)
    gather_ops(a, P, n_ops, b, out, LC, b * C + o0, n, tid, NT, [&](int c) { return pos(ix[c]); });
}

// Gather pass after the last merge pass, a 1-D grid of L x (n_ops - P)
// blocks: operand t = P + block % (n_ops - P) of lane b is staged in
// shared memory whole (C int32, read once and coalesced), then written
// out through the final positions pos (int32 [L, C]), so that no gather
// reads device memory at random.
#define LS_GATHER_THREADS 512
template <class A>
__global__ void __launch_bounds__(LS_GATHER_THREADS)
    merge_gather_kernel(const __grid_constant__ A a, const int* pos, int* out, int n_ops, int P,
                        int L, int C) {
  int* stage = (int*)ls_smem;
  const int G = n_ops - P;
  const long long b = blockIdx.x / G;
  const int t = P + (int)(blockIdx.x % G);
  const int* src = a.in[t] + b * a.rs[t];
  const long long cs = a.cs[t];
  for (int c = threadIdx.x; c < C; c += blockDim.x) cp_async4(stage + c, src + c * cs);
  cp_async_wait_all();
  __syncthreads();
  const int* p = pos + b * C;
  int* dst = out + ((size_t)t * L + b) * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) dst[c] = stage[p[c]];
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

// bytes of shared memory one block may opt into (sm_90)
#define LS_SMEM_MAX 232448

template <int NK, class A>
static int launch_net(const A& a, int* out, int n_ops, int nk, int L, int C, int C2,
                      cudaStream_t stream) {
  const size_t smem = ((size_t)2 * (NK + 1) + (nk - NK)) * C2 * sizeof(unsigned);
  if (C2 / LS_E > LS_NET_THREADS(NK) || smem > LS_SMEM_MAX) return -3;
  cudaError_t err = allow_smem((const void*)lane_sort_net_kernel<NK, A>, smem);
  if (err != cudaSuccess) return err;
  lane_sort_net_kernel<NK, A><<<L, C2 / LS_E, smem, stream>>>(a, out, n_ops, nk, L, C, C2);
  return cudaGetLastError();
}

template <class A>
static int run_net(const A& a, int* out, int n_ops, int nk, int L, int C, cudaStream_t s) {
  // at least one full warp of threads: small lanes sort more pad rows
  const int C2 = pow2_at_least(C, 32 * LS_E);
  switch (nk < LS_P_MAX ? nk : LS_P_MAX) {
    case 1: return launch_net<1>(a, out, n_ops, nk, L, C, C2, s);
    case 2: return launch_net<2>(a, out, n_ops, nk, L, C, C2, s);
    case 3: return launch_net<3>(a, out, n_ops, nk, L, C, C2, s);
    case 4: return launch_net<4>(a, out, n_ops, nk, L, C, C2, s);
    case 5: return launch_net<5>(a, out, n_ops, nk, L, C, C2, s);
    case 6: return launch_net<6>(a, out, n_ops, nk, L, C, C2, s);
    case 7: return launch_net<7>(a, out, n_ops, nk, L, C, C2, s);
    case 8: return launch_net<8>(a, out, n_ops, nk, L, C, C2, s);
    case 9: return launch_net<9>(a, out, n_ops, nk, L, C, C2, s);
    case 10: return launch_net<10>(a, out, n_ops, nk, L, C, C2, s);
    case 11: return launch_net<11>(a, out, n_ops, nk, L, C, C2, s);
    default: return launch_net<12>(a, out, n_ops, nk, L, C, C2, s);
  }
}

// Threads of a tile or merge block of `rows` rows: LS_ME rows each, and
// at least LS_MIN_THREADS for the loads, stores and gathers.
#define LS_MIN_THREADS 128
static int merge_threads(int rows) {
  return rows / LS_ME > LS_MIN_THREADS ? rows / LS_ME : LS_MIN_THREADS;
}

template <class A>
static int run_merge(const A& a, int* out, int* ws, int n_ops, int nk, int L, int C, int T,
                     int S, cudaStream_t stream) {
  const int P = nk < LS_P_MAX ? nk : LS_P_MAX;
  const long long tiles = ((long long)C + T - 1) / T, chunks = ((long long)C + S - 1) / S;
  if (L * tiles > 0x7fffffffLL || L * chunks > 0x7fffffffLL ||
      L * (long long)(n_ops - P) > 0x7fffffffLL)
    return -3;
  // heads, the other carried words, two index buffers; the pass also
  // keeps the positions (and two splits) but one index buffer
  const size_t tile_smem = (size_t)T * (8 + 4 * (P > 2 ? P - 2 : 0) + 4);
  const size_t pass_smem = (size_t)S * (8 + 4 * (P - 1) + 2) + 8;
  if (tile_smem > LS_SMEM_MAX || pass_smem > LS_SMEM_MAX) return -3;
  cudaError_t err = allow_smem((const void*)merge_tile_kernel<A>, tile_smem);
  if (err != cudaSuccess) return err;
  merge_tile_kernel<A><<<(unsigned)(L * tiles), merge_threads(T), tile_smem, stream>>>(
      a, ws, out, n_ops, nk, P, L, C, T, (int)tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (tiles == 1) return 0;
  if ((err = allow_smem((const void*)merge_pass_kernel<A>, pass_smem)) != cudaSuccess) return err;
  // the last pass leaves the operands past P to the gather pass when a
  // lane of one fits shared memory
  const size_t gather_smem = (size_t)C * sizeof(int);
  const bool staged = n_ops > P && gather_smem <= LS_SMEM_MAX;
  int* src = ws;
  int* dst = ws + (size_t)(P + 1) * L * C;
  for (long long R = T; R < C; R <<= 1) {
    const int last = 2 * R < C ? 0 : staged ? 2 : 1;
    merge_pass_kernel<A><<<(unsigned)(L * chunks), merge_threads(S), pass_smem, stream>>>(
        a, src, dst, out, n_ops, nk, P, L, C, R, S, (int)chunks, last);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    int* t = src;
    src = dst;
    dst = t;
  }
  if (!staged) return 0;
  if ((err = allow_smem((const void*)merge_gather_kernel<A>, gather_smem)) != cudaSuccess)
    return err;
  merge_gather_kernel<A><<<(unsigned)(L * (n_ops - P)), LS_GATHER_THREADS, gather_smem, stream>>>(
      a, src + (size_t)P * L * C, out, n_ops, P, L, C);
  return cudaGetLastError();
}

// `a` points to a host SmallArgs when n_ops <= LS_SMALL_OPS, else to a
// LargeArgs; it is passed to the kernels by value.  `out` is the
// contiguous int32 [n_ops, L, C] device output.  Each entry returns 0, a
// CUDA error code, -2 when n_ops or num_keys is out of range, or -3 when
// the shape is beyond the route.
static bool bad_counts(int n_ops, int num_keys) {
  return n_ops < 1 || n_ops > LS_MAX_OPS || num_keys < 1 || num_keys > n_ops;
}

// Route "regs": at most LS_NK_MAX keys, C2 <= LS_C2_MAX.
extern "C" int lane_sort_regs(const void* a, int* out, int n_ops, int num_keys, int L, int C,
                              void* stream) {
  if (bad_counts(n_ops, num_keys) || num_keys > LS_NK_MAX) return -2;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_ops <= LS_SMALL_OPS) return run_net(*(const SmallArgs*)a, out, n_ops, num_keys, L, C, s);
  return run_net(*(const LargeArgs*)a, out, n_ops, num_keys, L, C, s);
}

// Route "perm": any key count, C2 <= LS_PERM_C2_MAX past LS_NK_MAX keys
// (the staged key words and both exchange buffers within shared memory).
extern "C" int lane_sort_perm(const void* a, int* out, int n_ops, int num_keys, int L, int C,
                              void* stream) {
  if (bad_counts(n_ops, num_keys)) return -2;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_ops <= LS_SMALL_OPS) return run_net(*(const SmallArgs*)a, out, n_ops, num_keys, L, C, s);
  return run_net(*(const LargeArgs*)a, out, n_ops, num_keys, L, C, s);
}

// Route "merge": tiles of T rows and merge windows of S rows (powers of
// two, LS_T_MIN <= S <= T <= LS_T_MAX; ops/sort.py `merge_plan`), and
// `ws`, an int32 [2, P + 1, L, C] device workspace (unused, and may be
// null, when C <= T).
extern "C" int lane_sort_merge(const void* a, int* out, int* ws, int n_ops, int num_keys, int L,
                               int C, int T, int S, void* stream) {
  if (bad_counts(n_ops, num_keys)) return -2;
  if (T < LS_T_MIN || T > LS_T_MAX || (T & (T - 1)) || S < LS_T_MIN || S > T || (S & (S - 1)))
    return -3;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_ops <= LS_SMALL_OPS)
    return run_merge(*(const SmallArgs*)a, out, ws, n_ops, num_keys, L, C, T, S, s);
  return run_merge(*(const LargeArgs*)a, out, ws, n_ops, num_keys, L, C, T, S, s);
}
