// Causal, optionally sliding-window, GQA flash attention, forward only, for
// f32 inputs, on the CUDA cores.
//
// Replaces the TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas
// (body _flash_kernel) for f32 inputs, and computes what it computes:
//
//   out[b, i, h] = sum_j softmax_j(cap(q[b, i, h] . k[b, j, h / G] * Dh^-0.5))
//                  * v[b, j, h / G]
//
// over the keys j with j <= i and, when window > 0, i - j < window.
// q (B, S, H, Dh), k and v (B, S, Kh, Dh), f32, contiguous, 16-byte
// aligned; G = H / Kh, so query head h reads kv head h / G.  cap(x) =
// tanh(x / softcap) * softcap when softcap > 0.  The _rows entry takes a
// query offset: q (B, Sq, H, Dh) holds the rows at positions q_off .. q_off
// + Sq - 1 of a sequence whose keys k, v are (B, Sk, Kh, Dh), q_off + Sq <=
// Sk (a rank's rows of a sequence split over ranks); i above is the
// position, and the masks, the first key tile and the heaviest-first order
// use positions, the rows of q and out their local index.  q_off = 0 with
// Sq = Sk is the plain entry, the same arithmetic.  Scores, the online softmax
// (m, l, acc) and the probabilities are f32, every product an f32 FMA in
// increasing Dh (then key) order; out is acc / max(l, 1e-30).  Dh is 32,
// 64, 112, 128 or 256.  Dh 112 runs as 128 in shared memory (DP below):
// the padding columns of Q, K and V load as 0, so each score's in-order
// chain of FMAs over Dh only adds exact zeros at its end, and the output's
// padding columns are computed and not stored.  bf16 inputs go to
// flash_attention_wgmma.cu.
//
// Bound: operations.  Each kept (query, key) pair costs 4 * Dh flops (its
// score and its share of P V), at the card's f32 CUDA-core rate (67
// TFLOP/s).  Not the tensor cores: split TF32 (each product as hi.hi +
// hi.lo + lo.hi, variants/flash_attention_tf32.cu) left 1.8e-5 against
// the 1e-5 tolerance at recurrentgemma's shape, 1.7e-5 with every product
// exact: the tensor cores sum 8 products at a time in their own order, and
// at these logits any order but the plain version's moves the output by
// about 1e-5 (launch/tune_flash.py).
//
// Design.  An FMA whose operands both come from shared memory needs 8
// bytes, and an SM reads 128 bytes a clock against 128 FMAs a clock, so a
// thread must reuse what it reads: each computes an 8 x 8 register tile of
// scores, 8 rows x 8 keys, from 8 + 8 values a Dh step (4 FMAs a value
// read; the earlier 4 x 4 tiles did 2), and an 8 x Dh/KG tile of
// the output from 8 probabilities (one broadcast read) and Dh/KG values
// of V.
// One block per (batch, kv head, group of query heads, block of queries):
// its 64 rows are (query, head) pairs of one kv head in query-major order,
// g_blk = min(G, 64) heads times bq = 64 / g_blk queries, so each K/V tile
// serves the whole head group.  A row group of 8 rows belongs to KG
// threads (a half-warp, at Dh 256 a warp), thread kg taking keys kg + KG j
// of a tile of BK = 8 KG keys, so every shared-memory read is
// conflict-free or a broadcast and a row's KG threads reduce its max and
// sum by shuffles.  Q stays in shared memory; K and V stream through a
// ring of two chunks filled by cp.async, the copy of chunk c + 1 in
// flight while chunk c is used: a tile's K as Dh/32 chunks of (BK keys,
// 32 dims), then its V as Dh/32 chunks of (BK / (Dh/32) keys, Dh dims).
// The tile's probabilities go through shared memory (64 x BK) to the P V
// product, whose output tile, 8 rows x Dh/KG columns, stays in registers.
// Each score sums Dh in increasing order: so does the plain version's
// cuBLAS product, and at these logits (recurrentgemma's shape in f32) any
// other order (split TF32's, or two halves of Dh summed at the end) moved
// the output by about 1e-5 on its own.  At Dh <= 128 a block is 128
// threads (KG 16, 128-key tiles) in at most 105 KiB, two blocks an SM; at
// Dh 256 it is 256 threads (KG 32, 256-key tiles) in 205 KiB, one block
// and eight warps an SM.
// The block walks only keys some row can see, from max(0, q0 - window + 1)
// to its last query; the per-element causal/window test runs only on tiles
// that cross the diagonal or the window's edge.  Masked scores are -inf; a
// row whose keys so far are all masked keeps m = -inf and takes p = 0 and
// alpha = 0, so a wholly masked tile adds nothing whatever order the tiles
// come in (the TPU kernel instead lets a later real key wipe such garbage:
// kernel.py:63-73).  Blocks are numbered so that the q-blocks with the
// most keys start first.
//
// Plain C interface, loaded with ctypes.  The entry point returns the
// cudaError_t of its launch; the wrapper raises on anything but success.
// The wrapper's plan (ops.plan_f32) mirrors the launch below.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;       // (query, head) rows per block
constexpr int kDC = 32;         // Dh of one K chunk
constexpr int kPad = 4;         // floats of padding per shared-memory row
constexpr int kKld = kDC + kPad;

template <int DH>
struct Cfg {
  // head dim in shared memory: Dh rounded up to 32, 64, 128 or 256
  static constexpr int DP = DH <= 32 ? 32 : DH <= 64 ? 64 : DH <= 128 ? 128
                                                                     : 256;
  // KG threads share a row group (8 rows), one per 8 keys of the tile
  static constexpr int KG = DP == 256 ? 32 : 16;
  static constexpr int THREADS = 8 * KG;          // 8 row groups
  static constexpr int BK = 8 * KG;               // keys per tile
  static constexpr int SLOT = BK * kKld;          // floats of a ring slot
  static constexpr int QLD = DP + kPad;
  static constexpr int PLD = BK + 16;             // P row pitch
  static constexpr int VC = DP == 256 ? 32 : 4096 / DP;  // keys a V chunk
  static constexpr int NK = DP / kDC;             // K chunks a tile
  static constexpr int NV = BK / VC;              // V chunks a tile
  static constexpr int VW = DP >= 64 ? 4 : 2;     // output vector width
  static constexpr int NVW = DP / (KG * VW);      // output vectors a row
  static constexpr int FLOATS = kRows * QLD + 2 * SLOT + kRows * PLD;
  static constexpr int SMEM = 4 * FLOATS;
  static_assert(VC * (DP + kPad) <= SLOT, "a V chunk fits a slot");
  static_assert(NK == NV, "K and V chunks alternate per tile");
  static_assert(BK * 8 == 8 * THREADS && VC * DP / 4 == 8 * THREADS,
                "8 16-byte copies a thread a chunk");
  static_assert(DH % 4 == 0, "a row is whole 16-byte chunks");
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// max and sum over the N lanes that share a row (N = 16 or 32)
template <int N>
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = N / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
template <int N>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = N / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// element e (a constant once unrolled) of a float4
__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <int DH>
__global__ void __launch_bounds__(Cfg<DH>::THREADS, Cfg<DH>::DP == 256 ? 1
                                                                      : 2)
flash_fwd(float* __restrict__ out, const float* __restrict__ q,
          const float* __restrict__ k, const float* __restrict__ v,
          int s_len, int s_kv, int q_off, int n_heads, int n_kv, int n_bk,
          int g_blk, int bq, int n_qblk, int n_grp, int window,
          float softcap, float scale) {
  using C = Cfg<DH>;
  constexpr int NT = C::THREADS, KG = C::KG, BK = C::BK, SLOT = C::SLOT,
                QLD = C::QLD, PLD = C::PLD, VC = C::VC, NK = C::NK,
                VW = C::VW, NVW = C::NVW, DP = C::DP;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                             // kRows x QLD
  float* ring = qs + kRows * QLD;               // 2 x SLOT
  float* ps = ring + 2 * SLOT;                  // kRows x PLD
  const uint32_t ring_s =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring));

  // block -> (q-block, head group, batch x kv head); most keys first
  const int bid = blockIdx.x;
  const int qblk = n_qblk - 1 - bid / (n_grp * n_bk);
  const int grp = (bid / n_bk) % n_grp;
  const int bk = bid % n_bk;
  const int g = n_heads / n_kv;
  const int b = bk / n_kv, kvh = bk % n_kv;
  const int g0 = grp * g_blk;
  const int q0 = qblk * bq;
  const int tid = threadIdx.x;
  const int rg = tid / KG;      // rows 8 rg .. 8 rg + 7
  const int kg = tid % KG;      // keys kg + KG j of a tile
  const int64_t tok = static_cast<int64_t>(n_heads) * DH;   // q/out stride
  const int64_t ktok = static_cast<int64_t>(n_kv) * DH;     // k/v stride
  const float* kb = k + static_cast<int64_t>(b) * s_kv * ktok +
                    static_cast<int64_t>(kvh) * DH;
  const float* vb = v + static_cast<int64_t>(b) * s_kv * ktok +
                    static_cast<int64_t>(kvh) * DH;

  // Q rows of the block (dead rows and padding columns are 0), with the
  // first chunk
  {
    const uint32_t qs_s = static_cast<uint32_t>(__cvta_generic_to_shared(qs));
    for (int idx = tid; idx < kRows * DP / 4; idx += NT) {
      const int r = idx / (DP / 4), c4 = idx % (DP / 4);
      const int qi = r / g_blk, gi = r % g_blk, qp = q0 + qi;
      const bool ok = 4 * c4 < DH && qi < bq && g0 + gi < g && qp < s_len;
      const float* src =
          ok ? q + (static_cast<int64_t>(b) * s_len + qp) * tok +
                   static_cast<int64_t>(kvh * g + g0 + gi) * DH + 4 * c4
             : q;
      cp_async16(qs_s + 4 * (r * QLD + 4 * c4), src, ok);
    }
  }

  // positions: the block's first and last query, its first visible key
  const int p0 = q_off + q0;
  const int q_last = q_off + min(q0 + bq, s_len) - 1;
  const int k_begin = window > 0 ? max(0, p0 - window + 1) : 0;
  const int n_tiles = (q_last - k_begin) / BK + 1;
  const int n_chunks = n_tiles * 2 * NK;

  // chunk ci into ring slot ci & 1: of tile ci / (2 NK), K chunk c < NK
  // (BK keys x 32 dims from Dh 32 c), else V chunk c - NK (VC keys x DP);
  // columns at or past Dh read as 0
  auto load_chunk = [&](int ci) {
    const int t = ci / (2 * NK), c = ci % (2 * NK);
    const int k0 = k_begin + t * BK;
    const uint32_t dst = ring_s + 4 * SLOT * (ci & 1);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int p = tid + NT * u;
      if (c < NK) {
        const int key = p >> 3, c4 = p & 7, kp = k0 + key;
        const bool ok = kp < s_kv && kDC * c + 4 * c4 < DH;
        cp_async16(dst + 4 * (key * kKld + 4 * c4),
                   ok ? kb + kp * ktok + kDC * c + 4 * c4 : kb, ok);
      } else {
        const int key = p / (DP / 4), c4 = p % (DP / 4);
        const int kp = k0 + (c - NK) * VC + key;
        const bool ok = kp < s_kv && 4 * c4 < DH;
        cp_async16(dst + 4 * (key * (DP + kPad) + 4 * c4),
                   ok ? vb + kp * ktok + 4 * c4 : vb, ok);
      }
    }
    cp_async_commit();
  };

  // this thread's 8 rows: (row of q, query position, liveness)
  int qrow[8], qpos[8];
  bool live[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = 8 * rg + i, qi = r / g_blk, gi = r % g_blk;
    qrow[i] = q0 + qi;
    qpos[i] = q_off + qrow[i];
    live[i] = qi < bq && g0 + gi < g && qrow[i] < s_len;
  }
  const bool capped = softcap > 0.f;

  // the output tile: 8 rows x columns VW kg + KG VW m + e
  float m[8], l[8], o[8][NVW * VW];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int x = 0; x < NVW * VW; ++x) o[i][x] = 0.f;
  }

  load_chunk(0);
  int ci = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * BK;

    // S = Q K^T over the tile's K chunks, Dh in order
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int c = 0; c < NK; ++c, ++ci) {
      cp_async_wait_all();
      __syncthreads();          // chunk ci is in; chunk ci - 1 is used up
      if (ci + 1 < n_chunks) load_chunk(ci + 1);
      const float* kc = ring + SLOT * (ci & 1);
#pragma unroll 2
      for (int dq = 0; dq < kDC / 4; ++dq) {
        float4 qv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          qv[i] = *reinterpret_cast<const float4*>(
              qs + (8 * rg + i) * QLD + kDC * c + 4 * dq);
        float4 kv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          kv[j] = *reinterpret_cast<const float4*>(
              kc + (kg + KG * j) * kKld + 4 * dq);
        // one Dh step for all 64 scores before the next: the same order of
        // each score's sum, and no FMA waiting on the one before it
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 8; ++i)
              s[i][j] = fmaf(lane4(qv[i], c4), lane4(kv[j], c4), s[i][j]);
      }
    }
    // online softmax per row, over the KG lanes that share it
    const bool need_mask =
        k0 + BK - 1 > p0 || (window > 0 && k0 < q_last - window + 1);
    float alpha[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x = s[i][j] * scale;
        if (capped) x = tanhf(x / softcap) * softcap;
        if (need_mask) {
          const int kp = k0 + kg + KG * j;
          const bool keep = live[i] && kp <= qpos[i] &&
                            (window <= 0 || qpos[i] - kp < window);
          x = keep ? x : -INFINITY;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max<KG>(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = expf(m[i] - m_use);            // 0 while m[i] is -inf
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_use);  // 0 for a masked score
        psum += p;
        ps[(8 * rg + i) * PLD + kg + KG * j] = p;
      }
      l[i] = alpha[i] * l[i] + row_sum<KG>(psum);
      m[i] = m_new;
#pragma unroll
      for (int x = 0; x < NVW * VW; ++x) o[i][x] *= alpha[i];
    }

    // O += P V over the tile's V chunks
    for (int c = 0; c < NK; ++c, ++ci) {
      cp_async_wait_all();
      __syncthreads();          // chunk ci (and the tile's P) is in
      if (ci + 1 < n_chunks) load_chunk(ci + 1);
      const float* vc = ring + SLOT * (ci & 1);
      const int kv0 = c * VC;   // the chunk's first key in the tile
#pragma unroll 2
      for (int kq = 0; kq < VC / 4; ++kq) {
        float4 pv4[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          pv4[i] = *reinterpret_cast<const float4*>(
              ps + (8 * rg + i) * PLD + kv0 + 4 * kq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* vrow = vc + (4 * kq + kk) * (DP + kPad);
#pragma unroll
          for (int mm = 0; mm < NVW; ++mm) {
            float vv[VW];
            if constexpr (VW == 4) {
              const float4 x = *reinterpret_cast<const float4*>(
                  vrow + 4 * kg + 4 * KG * mm);
              vv[0] = x.x; vv[1] = x.y; vv[2] = x.z; vv[3] = x.w;
            } else {
              const float2 x =
                  *reinterpret_cast<const float2*>(vrow + 2 * kg);
              vv[0] = x.x; vv[1] = x.y;
            }
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int e = 0; e < VW; ++e)
                o[i][VW * mm + e] =
                    fmaf(lane4(pv4[i], kk), vv[e], o[i][VW * mm + e]);
          }
        }
      }
    }
  }

  // out = O / max(l, 1e-30)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (!live[i]) continue;
    const float den = fmaxf(l[i], 1e-30f);
    const int r = 8 * rg + i;
    float* orow = out + (static_cast<int64_t>(b) * s_len + qrow[i]) * tok +
                  static_cast<int64_t>(kvh * g + g0 + r % g_blk) * DH;
#pragma unroll
    for (int mm = 0; mm < NVW; ++mm) {
      const int col = VW * kg + KG * VW * mm;
      if (col >= DH) continue;              // a padding column
      if constexpr (VW == 4) {
        *reinterpret_cast<float4*>(orow + col) = make_float4(
            o[i][4 * mm] / den, o[i][4 * mm + 1] / den,
            o[i][4 * mm + 2] / den, o[i][4 * mm + 3] / den);
      } else {
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(o[i][0] / den, o[i][1] / den);
      }
    }
  }
}

template <int DH>
cudaError_t launch(void* out, const void* q, const void* k, const void* v,
                   int b, int s, int sk, int q_off, int h, int kh, int window,
                   float softcap, float scale, cudaStream_t stream) {
  constexpr int smem = Cfg<DH>::SMEM;
  const int g = h / kh;
  if (q_off < 0 || static_cast<long long>(q_off) + s > sk)
    return cudaErrorInvalidValue;
  const int g_blk = g < kRows ? g : kRows;
  const int bq = kRows / g_blk;
  const int n_qblk = (s + bq - 1) / bq, n_grp = (g + g_blk - 1) / g_blk;
  const long long blocks = static_cast<long long>(n_qblk) * n_grp * b * kh;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd<DH><<<static_cast<unsigned>(blocks), Cfg<DH>::THREADS, smem,
                  stream>>>(
      static_cast<float*>(out), static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v), s, sk,
      q_off, h, kh, b * kh, g_blk, bq, n_qblk, n_grp, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

// query rows q_off .. q_off + s - 1 of a sequence of sk keys
extern "C" int flash_attention_fwd_rows(void* out, const void* q,
                                        const void* k, const void* v, int b,
                                        int s, int sk, int q_off, int h,
                                        int kh, int dh, int window,
                                        float softcap, float scale,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
#define CASE(D)                                                             \
  case D:                                                                   \
    err = launch<D>(out, q, k, v, b, s, sk, q_off, h, kh, window, softcap,  \
                    scale, st);                                             \
    break;
    CASE(32) CASE(64) CASE(112) CASE(128) CASE(256)
#undef CASE
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// a whole sequence: q_off = 0, sk = s
extern "C" int flash_attention_fwd(void* out, const void* q, const void* k,
                                   const void* v, int b, int s, int h,
                                   int kh, int dh, int window, float softcap,
                                   float scale, void* stream) {
  return flash_attention_fwd_rows(out, q, k, v, b, s, s, 0, h, kh, dh,
                                  window, softcap, scale, stream);
}

// the shared memory the launch above asks for at head dim dh (0: none),
// so the wrapper's plan can be held to the kernel's
extern "C" int flash_attention_f32_smem(int dh) {
  switch (dh) {
    case 32: return Cfg<32>::SMEM;
    case 64: return Cfg<64>::SMEM;
    case 112: return Cfg<112>::SMEM;
    case 128: return Cfg<128>::SMEM;
    case 256: return Cfg<256>::SMEM;
    default: return 0;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
