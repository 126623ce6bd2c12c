// Masked scatter fold of top-k uploads, accumulating in place.
//
// Replaces the TPU kernel
//   src/repro/kernels/masked_agg/kernel.py::masked_scatter_acc_pallas
// (body _make_scatter_acc_kernel), and computes what it computes:
//
//   for z in 0..Z-1 (in order), skipping rows with w_m[z] <= 0 and
//   w_rest[z] <= 0:
//     for j in 0..k-1:  p = idx[z, j];  w = mask[p] ? w_m[z] : w_rest[z]
//       acc[p] += (w > 0 ? v[z, j] * s[z, j / qb] : 0) * w
//
// acc (N,) f32 is updated in place; v (Z, k) int8, bf16 or f32; s (Z,
// k / qb) f32 scales, or none (bf16/f32 payloads); idx (Z, k) int32 with
// each row's indices distinct, sorted ascending and inside [0, N) (what
// comm.sparse_encode ships); mask (N,) bool; w_m, w_rest (Z,) f32 read
// from device memory.
//
// Bound: memory.  Each kept entry needs its value, index, mask byte and
// acc read and written: about Z*k*(sizeof(v) + 4 + 1 + 8) + 4*Z*k/qb
// bytes, against a few flops per entry.
//
// Design.  The TPU has no lane scatter, so its kernel builds a
// (k_tile, block_n) one-hot and contracts it on the matrix unit for every
// grid block.  Hopper scatters directly, so none of that is carried over.
// Indices are distinct within a row, so a row needs no atomics; they
// collide across rows, and atomics there would reorder the f32 adds (the
// reference adds row after row, as .at[].add does).  So each block owns a
// span of acc: it binary-searches every live row's sorted index list for
// the entries that land in its span (one thread per row, all rows at
// once), then applies the rows in z order, the entries of one row spread
// over its threads, with a barrier between rows.  A position belongs to
// one block only, so the result is deterministic and in the reference's
// order, in one launch.  An entry outside the block's span (only possible
// when the index contract is broken) is dropped, never written out of
// bounds.  Products and sums are rounded one by one (__fmul_rn, __fadd_rn),
// in the plain version's order, so the two agree bitwise.
//
// Plain C interface, loaded with ctypes.  The entry point returns the
// cudaError_t of its launch; the wrapper raises on anything but success.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const uint16_t* p) {  // bf16
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}
__device__ __forceinline__ float load1(const int8_t* p) {
  return static_cast<float>(__ldg(p));
}

// First j in [0, k) with row[j] >= target (k when there is none).
__device__ __forceinline__ int32_t lower_bound(const int32_t* row, int32_t k,
                                               int64_t target) {
  int32_t lo = 0, hi = k;
  while (lo < hi) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    if (static_cast<int64_t>(__ldg(row + mid)) < target)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <typename V, bool kScales>
__global__ void masked_scatter_acc(float* __restrict__ acc,
                                   const V* __restrict__ values,
                                   const float* __restrict__ scales,
                                   const int32_t* __restrict__ idx,
                                   const uint8_t* __restrict__ mask,
                                   const float* __restrict__ w_m,
                                   const float* __restrict__ w_rest,
                                   int32_t z_rows, int32_t k, int64_t n,
                                   int log2_qb, int64_t span) {
  extern __shared__ int32_t bounds[];  // [2 * z_rows]: lo, hi of each row
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * span;
  const int64_t n1 = n0 + span < n ? n0 + span : n;
  for (int32_t z = threadIdx.x; z < z_rows; z += blockDim.x) {
    const bool live = __ldg(w_m + z) > 0.f || __ldg(w_rest + z) > 0.f;
    const int32_t* row = idx + static_cast<int64_t>(z) * k;
    bounds[2 * z] = live ? lower_bound(row, k, n0) : 0;
    bounds[2 * z + 1] = live ? lower_bound(row, k, n1) : 0;
  }
  __syncthreads();
  const int32_t k_scales = k >> log2_qb;
  for (int32_t z = 0; z < z_rows; ++z) {
    const int32_t lo = bounds[2 * z], hi = bounds[2 * z + 1];
    const float wm = __ldg(w_m + z), wr = __ldg(w_rest + z);
    const int64_t base = static_cast<int64_t>(z) * k;
    for (int32_t j = lo + threadIdx.x; j < hi; j += blockDim.x) {
      const int64_t p = __ldg(idx + base + j);
      if (p < n0 || p >= n1) continue;
      const float w = mask[p] ? wm : wr;
      if (!(w > 0.f)) continue;
      float v = load1(values + base + j);
      if (kScales)
        v = __fmul_rn(v, __ldg(scales + static_cast<int64_t>(z) * k_scales +
                               (j >> log2_qb)));
      acc[p] = __fadd_rn(acc[p], __fmul_rn(v, w));
    }
    __syncthreads();  // row z's writes land before row z + 1 reads
  }
}

constexpr int kThreads = 256;
constexpr int64_t kSpan = 8192;  // acc positions owned by one block

template <typename V, bool kScales>
cudaError_t launch(void* acc, const void* values, const void* scales,
                   const void* idx, const void* mask, const void* w_m,
                   const void* w_rest, int32_t z, int32_t k, int64_t n,
                   int log2_qb, cudaStream_t stream) {
  const int64_t blocks = (n + kSpan - 1) / kSpan;
  const size_t smem = 2 * sizeof(int32_t) * static_cast<size_t>(z);
  masked_scatter_acc<V, kScales>
      <<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
          static_cast<float*>(acc), static_cast<const V*>(values),
          static_cast<const float*>(scales),
          static_cast<const int32_t*>(idx),
          static_cast<const uint8_t*>(mask),
          static_cast<const float*>(w_m), static_cast<const float*>(w_rest),
          z, k, n, log2_qb, kSpan);
  return cudaGetLastError();
}

}  // namespace

// value_kind: 0 = f32, 1 = bf16, 2 = int8.  scales may be null.
extern "C" int masked_scatter_acc_launch(void* acc, const void* values,
                                         const void* scales, const void* idx,
                                         const void* mask, const void* w_m,
                                         const void* w_rest, int32_t z,
                                         int32_t k, int64_t n, int log2_qb,
                                         int value_kind, void* stream) {
  if (z <= 0 || k <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sc = scales != nullptr;
  cudaError_t err = cudaErrorInvalidValue;
  switch (value_kind) {
    case 0:
      err = sc ? launch<float, true>(acc, values, scales, idx, mask, w_m,
                                     w_rest, z, k, n, log2_qb, s)
               : launch<float, false>(acc, values, scales, idx, mask, w_m,
                                      w_rest, z, k, n, log2_qb, s);
      break;
    case 1:
      err = sc ? launch<uint16_t, true>(acc, values, scales, idx, mask, w_m,
                                        w_rest, z, k, n, log2_qb, s)
               : launch<uint16_t, false>(acc, values, scales, idx, mask, w_m,
                                         w_rest, z, k, n, log2_qb, s);
      break;
    case 2:
      err = sc ? launch<int8_t, true>(acc, values, scales, idx, mask, w_m,
                                      w_rest, z, k, n, log2_qb, s)
               : launch<int8_t, false>(acc, values, scales, idx, mask, w_m,
                                       w_rest, z, k, n, log2_qb, s);
      break;
  }
  return static_cast<int>(err);
}
