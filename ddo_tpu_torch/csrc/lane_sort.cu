// K1: per-lane lexicographic multi-key sort (ddo_tpu_torch/ops/sort.py).
//
// Replaces the Pallas kernels `_packed_sort_kernel` (behind `sort_packed`)
// and `_sort_kernel` (behind `sort_lanes`) of ddo_tpu/ops/sort_pallas.py.
// Each of L lanes sorts its C int32 rows ascending, lexicographic on the
// first `num_keys` operands; the remaining operands are payload that
// follows the rows.  The sort is unstable, like lax.sort(is_stable=False):
// every engine call supplies a unique final key, so the order is total.
//
// Design: one CTA sorts one lane.  It copies the lane's key columns into
// shared memory, padded to C2 = next power of two (pad rows carry key-0 =
// 2^31-1 and also compare as greater than every real row, so they always
// sort last), and runs a bitonic network over an index PERMUTATION in
// shared memory, comparing key tuples.  Keys and payloads are then
// gathered once from global memory through the permutation.  No row is
// moved during the network, so payload operands cost one gather each.
// The operands arrive stacked as one contiguous int32 [n_ops, L, C]
// tensor, so any number of them is sorted by one launch.
//
// What bounds it: at the engine's C = 512 (knapsack, 4 keys, ~10 KB of
// shared memory) a lane is 45 compare-exchange stages of 256 pairs, each
// a few dependent shared-memory loads and one __syncthreads: it is bound
// by shared-memory compare-exchange latency and launch overhead, not by
// device-memory bandwidth (the lane's data is read once and written
// once).  C beyond shared memory (LCS, C ~ 28k) needs a multi-pass radix
// sort; the wrapper raises there instead of falling back.

#include <cuda_runtime.h>
#include <stddef.h>

// row a > row b in (is_pad, key_0, ..., key_{nk-1}) order
__device__ __forceinline__ bool row_greater(const int* keys, int C, int C2,
                                            int nk, int a, int b) {
  const bool pa = a >= C, pb = b >= C;
  if (pa != pb) return pa;
  for (int t = 0; t < nk; ++t) {
    const int x = keys[t * C2 + a], y = keys[t * C2 + b];
    if (x != y) return x > y;
  }
  return false;
}

// in, out: int32 [n_ops, L, C]; operand t of lane b starts at (t * L + b) * C
__global__ void lane_sort_kernel(const int* in, int* out, int n_ops, int num_keys,
                                 int L, int C, int C2) {
  extern __shared__ int smem[];
  int* keys = smem;                  // [num_keys][C2]
  int* perm = smem + num_keys * C2;  // [C2]
  const size_t base = (size_t)blockIdx.x * C;
  const size_t stride = (size_t)L * C;  // between operands

  for (int c = threadIdx.x; c < C2; c += blockDim.x) {
    perm[c] = c;
    for (int t = 0; t < num_keys; ++t)
      keys[t * C2 + c] = c < C ? in[t * stride + base + c] : (t == 0 ? 0x7fffffff : 0);
  }
  __syncthreads();

  for (int k = 2; k <= C2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (C2 >> 1); p += blockDim.x) {
        const int i = 2 * p - (p & (j - 1));  // pair (i, i + j), bit j of i clear
        const int l = i + j;
        const int a = perm[i], b = perm[l];
        const bool ascending = (i & k) == 0;
        const bool swap = ascending ? row_greater(keys, C, C2, num_keys, a, b)
                                    : row_greater(keys, C, C2, num_keys, b, a);
        if (swap) {
          perm[i] = b;
          perm[l] = a;
        }
      }
      __syncthreads();
    }
  }

  for (int t = 0; t < n_ops; ++t) {
    const int* src = in + t * stride + base;
    int* dst = out + t * stride + base;
    for (int c = threadIdx.x; c < C; c += blockDim.x) dst[c] = src[perm[c]];
  }
}

// Sorts the `n_ops` operands of the contiguous int32 [n_ops, L, C] device
// array `in` into `out` (the same shape) on `stream`, in one launch.
// Returns 0, a CUDA error code, -1 when the lane does not fit in shared
// memory, or -2 when num_keys is not in [1, n_ops].
extern "C" int lane_sort(const int* in, int* out, int n_ops, int num_keys, int L,
                         int C, void* stream) {
  if (num_keys < 1 || num_keys > n_ops) return -2;
  int C2 = 2;
  while (C2 < C) C2 <<= 1;
  const size_t smem = (size_t)(num_keys + 1) * C2 * sizeof(int);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > (size_t)optin) return -1;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(lane_sort_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int threads = C2 >> 1;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;

  lane_sort_kernel<<<L, threads, smem, (cudaStream_t)stream>>>(in, out, n_ops, num_keys,
                                                                L, C, C2);
  return cudaGetLastError();
}
