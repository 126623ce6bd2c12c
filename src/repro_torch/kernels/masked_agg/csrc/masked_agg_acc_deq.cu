// Dequantizing masked cohort fold, accumulating in place (the int8 wire).
//
// Replaces the TPU kernel
//   src/repro/kernels/masked_agg/kernel.py::masked_agg_acc_deq_pallas
// (body _make_agg_acc_deq_kernel), and computes what it computes:
//
//   acc[n] += sum_z gate(q[z, n] * s[z, n / qb]) * w[z, n]
//   w[z, n] = mask[n] ? w_m[z] : w_rest[z],  gate(v) = (w > 0) ? v : 0
//
// acc (N,) f32 is updated in place; q (Z, N) int8 is the wire payload;
// s (Z, N / qb) f32 the per-group scales, qb (quant_block) a power of two
// in 1..128 that divides N; mask (N,) bool; w_m, w_rest (Z,) f32 read from
// device memory.  A NaN client (NaN scales) at weight 0 is killed by the
// select gate: NaN * 0 would be NaN.
//
// Bound: memory.  The least traffic is Z*N (payload) + 4*Z*N/qb (scales)
// + 8N (acc read and written) + N (mask) bytes against about 3*Z*N flops.
// The design is K1's (masked_agg_acc.cu): a 1-D grid over N, the loop over
// Z inside each thread in a fixed order, no atomics, acc read and written
// once.  A thread owns 16 consecutive elements: one 16-byte load of int8
// per row, one 16-byte load of the mask, four float4s of acc.  With
// qb >= 16 the 16 elements share one scale, loaded once per row; smaller
// groups load their scales one by one (they hit L1).  The TPU kernel
// reshapes its tile to (Z, groups, qb) for the 128-lane layout; here the
// group of element n is just n >> log2(qb).  A ragged N (not a multiple of
// 16) or a misaligned pointer takes the scalar kernel.
//
// The products and the sum are rounded one by one (__fmul_rn, __fadd_rn:
// no FMA contraction), in the plain version's order, so the two agree
// bitwise.
//
// Plain C interface, loaded with ctypes.  The entry point returns the
// cudaError_t of its launch; the wrapper raises on anything but success.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float fold1(float s, int8_t q, float scale,
                                       bool in_m, float wm, float wr) {
  const float w = in_m ? wm : wr;
  const float x = __fmul_rn(static_cast<float>(q), scale);
  return __fadd_rn(s, __fmul_rn(w > 0.f ? x : 0.f, w));
}

// Requires N % 16 == 0, acc 16-byte, q 16-byte and mask 16-byte aligned
// (q's row stride N then keeps every row aligned).
__global__ void masked_agg_acc_deq_vec16(float* __restrict__ acc,
                                         const int8_t* __restrict__ q,
                                         const float* __restrict__ scales,
                                         const uint8_t* __restrict__ mask,
                                         const float* __restrict__ w_m,
                                         const float* __restrict__ w_rest,
                                         int64_t z_rows, int64_t n,
                                         int log2_qb) {
  const int64_t groups = n >> 4;
  const int64_t n_scales = n >> log2_qb;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < groups; g += stride) {
    const int64_t i = g << 4;
    float s[16];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(acc + i + 4 * k);
      s[4 * k] = a.x; s[4 * k + 1] = a.y; s[4 * k + 2] = a.z;
      s[4 * k + 3] = a.w;
    }
    const uint4 mv = __ldg(reinterpret_cast<const uint4*>(mask + i));
    const uint8_t* mb = reinterpret_cast<const uint8_t*>(&mv);
    bool in_m[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) in_m[j] = mb[j] != 0;
    for (int64_t z = 0; z < z_rows; ++z) {
      const uint4 qv = __ldg(reinterpret_cast<const uint4*>(q + z * n + i));
      const int8_t* qr = reinterpret_cast<const int8_t*>(&qv);
      const float wm = __ldg(w_m + z), wr = __ldg(w_rest + z);
      const float* srow = scales + z * n_scales;
      if (log2_qb >= 4) {
        const float sc = __ldg(srow + (i >> log2_qb));
#pragma unroll
        for (int j = 0; j < 16; ++j)
          s[j] = fold1(s[j], qr[j], sc, in_m[j], wm, wr);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          s[j] = fold1(s[j], qr[j], __ldg(srow + ((i + j) >> log2_qb)),
                       in_m[j], wm, wr);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<float4*>(acc + i + 4 * k) =
          make_float4(s[4 * k], s[4 * k + 1], s[4 * k + 2], s[4 * k + 3]);
  }
}

__global__ void masked_agg_acc_deq_scalar(float* __restrict__ acc,
                                          const int8_t* __restrict__ q,
                                          const float* __restrict__ scales,
                                          const uint8_t* __restrict__ mask,
                                          const float* __restrict__ w_m,
                                          const float* __restrict__ w_rest,
                                          int64_t z_rows, int64_t n,
                                          int log2_qb) {
  const int64_t n_scales = n >> log2_qb;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float s = acc[i];
    const bool in_m = mask[i] != 0;
    const int64_t grp = i >> log2_qb;
    for (int64_t z = 0; z < z_rows; ++z)
      s = fold1(s, q[z * n + i], __ldg(scales + z * n_scales + grp), in_m,
                __ldg(w_m + z), __ldg(w_rest + z));
    acc[i] = s;
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride loops cover the rest

}  // namespace

extern "C" int masked_agg_acc_deq(void* acc, const void* q,
                                  const void* scales, const void* mask,
                                  const void* w_m, const void* w_rest,
                                  int64_t z, int64_t n, int log2_qb,
                                  int vec16, void* stream) {
  const int64_t work = vec16 ? (n >> 4) : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  auto* a = static_cast<float*>(acc);
  auto* qq = static_cast<const int8_t*>(q);
  auto* sc = static_cast<const float*>(scales);
  auto* m = static_cast<const uint8_t*>(mask);
  auto* wm = static_cast<const float*>(w_m);
  auto* wr = static_cast<const float*>(w_rest);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec16)
    masked_agg_acc_deq_vec16<<<static_cast<unsigned>(blocks), kThreads, 0,
                               s>>>(a, qq, sc, m, wm, wr, z, n, log2_qb);
  else
    masked_agg_acc_deq_scalar<<<static_cast<unsigned>(blocks), kThreads, 0,
                                s>>>(a, qq, sc, m, wm, wr, z, n, log2_qb);
  return static_cast<int>(cudaGetLastError());
}
