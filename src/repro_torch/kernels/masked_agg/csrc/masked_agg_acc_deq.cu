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
// Bound: memory.  The least traffic is what the weights need: acc read
// (4N) and the mask (N), row z's payload (1 byte an element) and scales
// (4 bytes a group) only where its weight is live (w > 0), and acc written
// only where a live row changes it: Z*N + 4*Z*N/qb + 9N for complex
// clients, 5N + Z*|M| + 4*Z*(M's groups) + 4|M| for simple ones.
//
// The design is K1's (masked_agg_acc.cu): a 1-D grid over N, the loop over
// Z inside each thread in a fixed order, no atomics; a row's payload and
// scales read for a thread only when one of its elements is live for the
// row (whole warps skip the dead rows off M, and issue no request for
// them); acc read once and stored only where its bits can change (see
// unsettled below).  A thread owns 16 consecutive elements: one 16-byte
// load of int8 per live row, one 16-byte load of the mask, four float4s
// of acc.  With qb >= 16 the 16 elements share one scale, read with the
// payload; smaller groups read their scales one by one at the fold (they
// hit L1).  A row dead for all 16 adds its two products 0 * w_m and
// 0 * w_rest, taken once, instead of folding each element.  Measured on
// the card (PERF.md), 16 elements a thread beat K1's layout of 4 (a lane's
// 4-byte payload loads left the folds 30-40 % slower), and rows one at a
// time beat unrolled ones.
// The TPU kernel reshapes its tile to (Z, groups, qb) for the 128-lane
// layout; here the group of element n is just n >> log2(qb).  A ragged N
// (not a multiple of 16) or a misaligned pointer takes the scalar kernel,
// one element a thread.
//
// The products and the sum are rounded one by one (__fmul_rn, __fadd_rn:
// no FMA contraction), in the plain version's order and dead rows
// included (a row not read adds gate(0) * w, as the plain version does),
// so the two agree bitwise.
//
// Plain C interface, loaded with ctypes.  The entry point returns the
// cudaError_t of its launch; the wrapper raises on anything but success.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowUnroll = 1;   // rows whose loads are issued together
constexpr int64_t kMaxBlocks = 1 << 20;  // grid-stride loops cover the rest

// The payload and the scales are read once.
template <typename V>
__device__ __forceinline__ V load_once(const V* p) {
  return __ldg(p);
}

__device__ __forceinline__ float fold1(float s, float x, bool in_m, float wm,
                                       float wr) {
  const float w = in_m ? wm : wr;
  return __fadd_rn(s, __fmul_rn(w > 0.f ? x : 0.f, w));
}

__device__ __forceinline__ float deq(int8_t q, float scale) {
  return __fmul_rn(static_cast<float>(q), scale);
}

// Where no row is live for an element, each row adds 0 * w, which leaves
// every bit of s alone but a -0.0 (made +0.0 by a +0 product), a NaN's
// payload, or anything at a NaN or infinite weight (0 * w is NaN).  The
// vector kernel therefore stores its 16 elements when a row was read for
// them, when one held -0.0 or NaN (unsettled), or when a weight was not
// finite: a superset of the groups whose bits change, so acc ends as an
// unconditional store would leave it, and the group's loaded bits need no
// registers to compare against.
__device__ __forceinline__ bool unsettled(float v) {
  return __float_as_uint(v) == 0x80000000u || isnan(v);
}

// Requires N % 16 == 0, acc 16-byte, q 16-byte and mask 16-byte aligned
// (q's row stride N then keeps every row aligned).  kGroupScale: qb >= 16,
// one scale for the thread's 16 elements.
template <bool kGroupScale>
__global__ void __launch_bounds__(kThreads)
masked_agg_acc_deq_vec16(float* __restrict__ acc,
                         const int8_t* __restrict__ q,
                         const float* __restrict__ scales,
                         const uint8_t* __restrict__ mask,
                         const float* __restrict__ w_m,
                         const float* __restrict__ w_rest, int64_t z_rows,
                         int64_t n, int log2_qb) {
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
    bool in_m[16], any_m = false, all_m = true, store = false;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      in_m[j] = mb[j] != 0;
      any_m = any_m || in_m[j];
      all_m = all_m && in_m[j];
      store = store || unsettled(s[j]);
    }
#pragma unroll kRowUnroll
    for (int64_t z = 0; z < z_rows; ++z) {
      const float wm = __ldg(w_m + z), wr = __ldg(w_rest + z);
      const bool need = (any_m && wm > 0.f) || (!all_m && wr > 0.f);
      store = store || need || !isfinite(wm) || !isfinite(wr);
      if (need) {
        const float* srow = scales + z * n_scales;
        const uint4 qv = load_once(reinterpret_cast<const uint4*>(
            q + z * n + i));
        const float sc = kGroupScale ? load_once(srow + (i >> log2_qb)) : 0.f;
        const int8_t* qr = reinterpret_cast<const int8_t*>(&qv);
#pragma unroll
        for (int j = 0; j < 16; ++j)
          s[j] = fold1(s[j], deq(qr[j], kGroupScale
                                            ? sc
                                            : load_once(srow + ((i + j) >>
                                                                log2_qb))),
                       in_m[j], wm, wr);
      } else {
        // the row is dead for all 16: each adds gate(x) * w = 0 * w, as
        // fold1 would, with the two products taken once
        const float pm = __fmul_rn(0.f, wm), pr = __fmul_rn(0.f, wr);
#pragma unroll
        for (int j = 0; j < 16; ++j)
          s[j] = __fadd_rn(s[j], in_m[j] ? pm : pr);
      }
    }
    if (store) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        *reinterpret_cast<float4*>(acc + i + 4 * k) =
            make_float4(s[4 * k], s[4 * k + 1], s[4 * k + 2], s[4 * k + 3]);
    }
  }
}

// Any N and alignment: one element a thread, the vec16 kernel's skips and
// stores.
__global__ void __launch_bounds__(kThreads)
masked_agg_acc_deq_scalar(float* __restrict__ acc,
                          const int8_t* __restrict__ q,
                          const float* __restrict__ scales,
                          const uint8_t* __restrict__ mask,
                          const float* __restrict__ w_m,
                          const float* __restrict__ w_rest, int64_t z_rows,
                          int64_t n, int log2_qb) {
  const int64_t n_scales = n >> log2_qb;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float a = acc[i];
    const bool in_m = mask[i] != 0;
    const int64_t grp = i >> log2_qb;
    float s = a;
#pragma unroll kRowUnroll
    for (int64_t z = 0; z < z_rows; ++z) {
      const float wm = __ldg(w_m + z), wr = __ldg(w_rest + z);
      const bool need = (in_m ? wm : wr) > 0.f;
      const int8_t qv = need ? load_once(q + z * n + i) : int8_t{0};
      const float sc = need ? load_once(scales + z * n_scales + grp) : 0.f;
      s = fold1(s, deq(qv, sc), in_m, wm, wr);
    }
    if (__float_as_uint(s) != __float_as_uint(a)) acc[i] = s;
  }
}

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
  const unsigned grid = static_cast<unsigned>(blocks);
  auto* a = static_cast<float*>(acc);
  auto* qq = static_cast<const int8_t*>(q);
  auto* sc = static_cast<const float*>(scales);
  auto* m = static_cast<const uint8_t*>(mask);
  auto* wm = static_cast<const float*>(w_m);
  auto* wr = static_cast<const float*>(w_rest);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec16 && log2_qb >= 4)
    masked_agg_acc_deq_vec16<true><<<grid, kThreads, 0, s>>>(
        a, qq, sc, m, wm, wr, z, n, log2_qb);
  else if (vec16)
    masked_agg_acc_deq_vec16<false><<<grid, kThreads, 0, s>>>(
        a, qq, sc, m, wm, wr, z, n, log2_qb);
  else
    masked_agg_acc_deq_scalar<<<grid, kThreads, 0, s>>>(
        a, qq, sc, m, wm, wr, z, n, log2_qb);
  return static_cast<int>(cudaGetLastError());
}
