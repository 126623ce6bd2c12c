// Causal, optionally sliding-window, GQA flash attention, forward only.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _flash_kernel), and computes what it computes:
//
//   out[b, i, h] = sum_j softmax_j(cap(q[b, i, h] . k[b, j, h / G] * Dh^-0.5))
//                  * v[b, j, h / G]
//
// over the keys j with j <= i and, when window > 0, i - j < window.
// q (B, S, H, Dh), k and v (B, S, Kh, Dh), f32, contiguous; G = H / Kh,
// so query head h reads kv head h / G (the reference's (kh, g) split).
// cap(x) = tanh(x / softcap) * softcap when softcap > 0.  The online
// softmax (m, l, acc) and the probabilities stay f32; out is
// acc / max(l, 1e-30).  Dh is 32, 64, 128 or 256.  bf16 inputs go to the
// tensor-core kernel (flash_attention_wgmma.cu).
//
// Bound: operations.  Each kept (query, key) pair costs 4 * Dh flops (the
// score and its share of P.V) against 4 * Dh bytes of q, k, v and out per
// row, far above the card's balance point at the path's lengths
// (thousands of keys per query).  This first version runs on the CUDA
// cores in f32 (no tensor cores): f32 inputs must come out at f32
// accuracy, which bf16 or TF32 products would not give.  Its peak is the
// card's f32 CUDA-core rate (67 TFLOP/s).
//
// Design.  One block of 256 threads per (batch, kv head, group of query
// heads, block of BQ queries).  Its 64 rows are (head, query) pairs: all
// G query heads of the kv head (up to 64) times BQ = 64 / G queries, so
// every K/V tile it loads serves the whole group (recurrentgemma's MQA:
// 10 heads share each tile).  The block walks its keys in tiles of 64,
// in increasing order, from max(0, first query - window + 1) to its last
// query only: keys no row of the block can see are never loaded.  A
// tile's K and V sit in shared memory beside the block's Q rows (rows
// padded by 4 floats against bank conflicts); each thread
// owns 4 rows and computes a 4 x 4 register tile of scores, reduces each
// row's max and sum over the 16 threads that share it with warp shuffles,
// writes its probabilities to shared memory and accumulates a 4 x Dh/16
// tile of the output in registers.  Masked scores are -inf; a row whose
// keys so far are all masked keeps m = -inf and takes p = 0 and alpha = 0,
// so a fully masked tile (a window far behind the row's query) adds
// nothing, whatever order the tiles come in (the TPU kernel instead lets a
// later real key wipe such garbage: kernel.py:63-73).
//
// Plain C interface, loaded with ctypes.  The entry point returns the
// cudaError_t of its launch; the wrapper raises on anything but success.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // (head, query) rows per block
constexpr int kBK = 64;     // keys per tile
constexpr int kPad = 4;     // floats of padding per shared-memory row
constexpr int kLdP = kBK + kPad;

// 4 consecutive elements (one 16-byte load).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Copy `rows` rows of DH elements (row r at src + r * stride, rows at or
// beyond `valid` read as 0) into shared memory, row pitch DH + kPad.
template <typename T, int DH>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          int64_t stride, int rows,
                                          int valid) {
  constexpr int kVecs = DH / 4;
  for (int idx = threadIdx.x; idx < rows * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c = (idx % kVecs) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) v = load4(src + r * stride + c);
    *reinterpret_cast<float4*>(dst + r * (DH + kPad) + c) = v;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(T* __restrict__ out, const T* __restrict__ q,
          const T* __restrict__ k, const T* __restrict__ v, int s_len,
          int n_heads, int n_kv, int g_blk, int bq, int window,
          float softcap, float scale) {
  constexpr int kLd = DH + kPad;
  constexpr int kCpt = DH / 16;                 // output columns a thread
  constexpr int kVw = kCpt >= 4 ? 4 : kCpt;     // ... in vectors of kVw
  constexpr int kGroups = kCpt / kVw;
  extern __shared__ float smem[];
  float* qs = smem;                             // kRows x kLd
  float* ks = qs + kRows * kLd;                 // kBK x kLd
  float* vs = ks + kBK * kLd;                   // kBK x kLd
  float* ps = vs + kBK * kLd;                   // kRows x kLdP

  const int g = n_heads / n_kv;
  const int bk = blockIdx.z;                    // batch * n_kv + kv head
  const int b = bk / n_kv, kvh = bk % n_kv;
  const int g0 = blockIdx.y * g_blk;
  const int q0 = blockIdx.x * bq;
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;       // rows 4tr..4tr+3
  const int64_t tok = static_cast<int64_t>(n_heads) * DH;   // q/out stride
  const int64_t ktok = static_cast<int64_t>(n_kv) * DH;     // k/v stride

  // this thread's 4 rows: (head, query position, valid)
  int qpos[4], head[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr * 4 + i, gl = r / bq;
    qpos[i] = q0 + r % bq;
    head[i] = kvh * g + g0 + gl;
    live[i] = gl < g_blk && g0 + gl < g && qpos[i] < s_len;
  }

  // Q rows of the block; dead rows are 0
  for (int idx = tid; idx < kRows * (DH / 4); idx += kThreads) {
    const int r = idx / (DH / 4), c = (idx % (DH / 4)) * 4;
    const int gl = r / bq, qp = q0 + r % bq;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gl < g_blk && g0 + gl < g && qp < s_len)
      val = load4(q + (static_cast<int64_t>(b) * s_len + qp) * tok +
                  static_cast<int64_t>(kvh * g + g0 + gl) * DH + c);
    *reinterpret_cast<float4*>(qs + r * kLd + c) = val;
  }

  float m[4], l[4], acc[4][kCpt];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCpt; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + bq, s_len) - 1;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const T* kb = k + static_cast<int64_t>(b) * s_len * ktok +
                static_cast<int64_t>(kvh) * DH;
  const T* vb = v + static_cast<int64_t>(b) * s_len * ktok +
                static_cast<int64_t>(kvh) * DH;

  for (int k0 = k_begin; k0 <= q_last; k0 += kBK) {
    const int n_valid = min(kBK, s_len - k0);
    __syncthreads();            // the previous tile's readers are done
    load_rows<T, DH>(ks, kb + static_cast<int64_t>(k0) * ktok, ktok, kBK,
                     n_valid);
    load_rows<T, DH>(vs, vb + static_cast<int64_t>(k0) * ktok, ktok, kBK,
                     n_valid);
    __syncthreads();

    // scores: rows 4tr+i, keys k0 + tc + 16j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (tr * 4 + i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(ks + (tc + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          sc[i][j] = a;
        }
    }

    // online softmax per row, over the 16 threads that share it
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tc + 16 * j;
        float x = sc[i][j] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const bool keep = live[i] && kp <= qpos[i] &&
                          (window <= 0 || qpos[i] - kp < window);
        sc[i][j] = keep ? x : -INFINITY;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m[i] - m_use);   // 0 while m[i] is -inf
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_use);  // 0 for a masked score
        psum += p;
        ps[(tr * 4 + i) * kLdP + tc + 16 * j] = p;
      }
      l[i] = alpha * l[i] + sum16(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCpt; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();            // the tile's probabilities are written

    // acc += P V: rows 4tr+i, columns (grp * 16 + tc) * kVw + e
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(tr * 4 + i) * kLdP + kk];
#pragma unroll
      for (int grp = 0; grp < kGroups; ++grp) {
        const float* vp = vs + kk * kLd + (grp * 16 + tc) * kVw;
        float vv[kVw];
        if constexpr (kVw == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vp);
          vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
        } else {
#pragma unroll
          for (int e = 0; e < kVw; ++e) vv[e] = vp[e];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < kVw; ++e)
            acc[i][grp * kVw + e] = fmaf(p[i], vv[e], acc[i][grp * kVw + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!live[i]) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + (static_cast<int64_t>(b) * s_len + qpos[i]) * tok +
           static_cast<int64_t>(head[i]) * DH;
#pragma unroll
    for (int grp = 0; grp < kGroups; ++grp)
#pragma unroll
      for (int e = 0; e < kVw; ++e)
        store1(o + (grp * 16 + tc) * kVw + e, acc[i][grp * kVw + e] / den);
  }
}

template <typename T, int DH>
cudaError_t launch(void* out, const void* q, const void* k, const void* v,
                   int b, int s, int h, int kh, int window, float softcap,
                   float scale, cudaStream_t stream) {
  constexpr int kLd = DH + kPad;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(kRows + 2 * kBK) * kLd + kRows * kLdP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int g = h / kh;
  const int g_blk = g < kRows ? g : kRows;
  const int bq = kRows / g_blk;
  const dim3 grid(static_cast<unsigned>((s + bq - 1) / bq),
                  static_cast<unsigned>((g + g_blk - 1) / g_blk),
                  static_cast<unsigned>(b * kh));
  flash_fwd<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), s, h, kh, g_blk,
      bq, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dh, void* out, const void* q, const void* k,
                     const void* v, int b, int s, int h, int kh, int window,
                     float softcap, float scale, cudaStream_t stream) {
  switch (dh) {
    case 32: return launch<T, 32>(out, q, k, v, b, s, h, kh, window,
                                  softcap, scale, stream);
    case 64: return launch<T, 64>(out, q, k, v, b, s, h, kh, window,
                                  softcap, scale, stream);
    case 128: return launch<T, 128>(out, q, k, v, b, s, h, kh, window,
                                    softcap, scale, stream);
    case 256: return launch<T, 256>(out, q, k, v, b, s, h, kh, window,
                                    softcap, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention_fwd(void* out, const void* q, const void* k,
                                   const void* v, int b, int s, int h,
                                   int kh, int dh, int window, float softcap,
                                   float scale, void* stream) {
  return static_cast<int>(dispatch<float>(dh, out, q, k, v, b, s, h, kh,
                                          window, softcap, scale,
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
