// Flash attention forward for Hopper (sm_90a): online-softmax attention
// that never writes the S x S score matrix to device memory. One source,
// two kernels of the JAX package:
//
// K1 replaces `_flash_fwd_kernel` of metaflow_tpu/ops/attention.py
// (launched by `_flash_forward`). It computes the same function: bf16 (or
// f32) operands, f32 scores scaled after the product, causal mask
// q_pos >= k_pos, running max / denominator / accumulator in f32,
// probabilities rounded to the operand dtype before the P.V product, O
// written in the input dtype and lse = m + log(l) in f32.
//
// K4 replaces `_flash_block_fwd_kernel` (launched by `flash_block_fwd`),
// one hop of ring attention: the same loop WITHOUT the final
// normalization. It writes the f32 accumulator as it stands and the
// running max m and denominator l in natural-log units (m = max s,
// l = sum exp(s - m)), which the ring merges across hops; `causal` is then
// the same-shard diagonal mask, and a hop from an earlier shard runs every
// key tile. K4 is K1's body under a template flag (kBlock): only the
// epilogue differs.
//
// Both read q [B, S, H, D] and k, v [B, S, KV, D] through their strides
// (kv head h / (H / KV), no GQA repeat and no head fold copy; ring shards
// are views of the whole sequence), write O or acc as [B, S, H, D] and the
// row stats as [B*H, S] (no TPU sublane padding).
//
// Bounds. K1 at the main-path shape (B=2, S=2048, H=32, KV=8, D=128, bf16,
// causal): the two products cost 4*B*H*D*S(S+1)/2 = 68.7 GFLOP, which is
// 69 us at the card's 989 TFLOP/s dense bf16; the bytes (q, k, v read once,
// o written once, lse) are about 84 MB, 25 us at 3.35 TB/s. K4 at the ring
// hop of bench_1b at 8k context (B=2, S=2048 a shard, H=16, KV=8, D=128):
// 34.4 GFLOP on a diagonal hop and 68.7 on a full one (35 and 69 us)
// against about 67 MB (q, k, v, the f32 acc: 20 us). Both are bound by
// operations.
//
// What the design does about that bound: both products run on the tensor
// cores (mma.sync m16n8k16 bf16 -> f32, operands fetched with ldmatrix);
// each block keeps its 64-row Q tile resident and streams 64-key K/V tiles
// through a two-stage cp.async pipeline, so device memory is read about
// S/64 times less than a naive kernel would; k tiles past the diagonal are
// skipped, which halves the causal work; blocks with the most work are
// launched first. wgmma and TMA, which the full tensor-core rate needs, are
// left to later work. The float32 path (tests, off the main path) uses
// plain FMA in a warp-per-row kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace {

using namespace tile_mma;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;      // K1: O in the input dtype; K4: the f32 accumulator
  float* lse;   // K1: lse; K4: the running max m
  float* l;     // K4: the denominator l (unused by K1)
  int S, H, KV;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int BM = 64;      // q rows per block, 16 per warp
constexpr int BN = 64;      // keys per K/V tile
constexpr int NTHREADS = 128;

// Fragment layouts: see tile_mma.cuh.
template <int D, bool kBlock>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_bf16_kernel(Params p) {
  constexpr int LD = D + PAD;
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + BM * LD;      // [2][BN][LD]
  __nv_bfloat16* sV = sK + 2 * BN * LD;  // [2][BN][LD]

  const int qb = gridDim.x - 1 - blockIdx.x;  // most causal work first
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = qb * BM;
  const int S = p.S;

  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int c = tid; c < BM * CPR; c += NTHREADS) {
    const int r = c / CPR, col = (c % CPR) * 8, row = q0 + r;
    const bool ok = row < S;
    cp_async_16(sQ + r * LD + col, qg + (ok ? row : 0) * p.q_ss + col, ok);
  }
  auto load_kv = [&](int tile, int stage) {
    __nv_bfloat16* dK = sK + stage * BN * LD;
    __nv_bfloat16* dV = sV + stage * BN * LD;
    for (int c = tid; c < BN * CPR; c += NTHREADS) {
      const int r = c / CPR, col = (c % CPR) * 8, row = tile * BN + r;
      const bool ok = row < S;
      const long long rr = ok ? row : 0;
      cp_async_16(dK + r * LD + col, kg + rr * p.k_ss + col, ok);
      cp_async_16(dV + r * LD + col, vg + rr * p.v_ss + col, ok);
    }
  };

  int n_tiles = (S + BN - 1) / BN;
  if (p.causal) n_tiles = min(n_tiles, (q0 + BM + BN - 1) / BN);
  load_kv(0, 0);
  cp_async_commit();

  const float scale_log2 = p.scale * kLog2e;
  const int row_a = q0 + warp * 16 + g;  // this thread's two rows
  const int row_b = row_a + 8;
  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l_r[2] = {0.f, 0.f};              // this thread's partial row sums

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_kv(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* cK = sK + (t & 1) * BN * LD;
    const __nv_bfloat16* cV = sV + (t & 1) * BN * LD;

    // scores s = q k^T for this warp's 16 rows x BN keys
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, cK + (np * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scale in f32, mask, online softmax
    const int k0 = t * BN;
    const bool masked = (k0 + BN > S) || (p.causal && k0 + BN - 1 > q0 + warp * 16);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (masked) {
          const int key = k0 + j * 8 + t4 * 2 + (e & 1);
          const int row = (e < 2) ? row_a : row_b;
          if (key >= S || (p.causal && key > row)) x = -INFINITY;
        }
        s[j][e] = x;
      }
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float corr[2], mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mu[i] = (mx[i] == -INFINITY) ? 0.f : mx[i];  // a row with no key yet
      corr[i] = exp2f(m_r[i] - mu[i]);
      m_r[i] = mx[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mu[0]);
      s[j][1] = exp2f(s[j][1] - mu[0]);
      s[j][2] = exp2f(s[j][2] - mu[1]);
      s[j][3] = exp2f(s[j][3] - mu[1]);
      rs[0] += s[j][0] + s[j][1];
      rs[1] += s[j][2] + s[j][3];
    }
    l_r[0] = l_r[0] * corr[0] + rs[0];
    l_r[1] = l_r[1] * corr[1] + rs[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += p v: the score C fragments of two key groups form one A
    // fragment, with p rounded to bf16
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, cV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], a, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
  }
  if constexpr (kBlock) {
    // K4: the accumulator unnormalized in f32, m back in natural-log units
    // (the loop keeps it in log2 units), l to match it
    float* ag = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = n * 8 + t4 * 2;
      if (row_a < S)
        *reinterpret_cast<float2*>(ag + row_a * p.o_ss + col) =
            make_float2(acc[n][0], acc[n][1]);
      if (row_b < S)
        *reinterpret_cast<float2*>(ag + row_b * p.o_ss + col) =
            make_float2(acc[n][2], acc[n][3]);
    }
    if (t4 == 0) {
      const long long base = static_cast<long long>(bh) * S;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = i ? row_b : row_a;
        if (row < S) {
          p.lse[base + row] = m_r[i] * kLn2;
          p.l[base + row] = l_r[i];
        }
      }
    }
    return;
  }
  __nv_bfloat16* og =
      static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + t4 * 2;
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(og + row_a * p.o_ss + col) =
          pack_bf16(acc[n][0] / l_r[0], acc[n][1] / l_r[0]);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(og + row_b * p.o_ss + col) =
          pack_bf16(acc[n][2] / l_r[1], acc[n][3] / l_r[1]);
  }
  if (t4 == 0) {
    float* lse = p.lse + static_cast<long long>(bh) * S;
    if (row_a < S) lse[row_a] = m_r[0] * kLn2 + logf(l_r[0]);
    if (row_b < S) lse[row_b] = m_r[1] * kLn2 + logf(l_r[1]);
  }
}

// ---------------------------------------------------------------------------
// float32 kernel: one warp per q row, FMA only
// ---------------------------------------------------------------------------

constexpr int F32_ROWS = 8;   // q rows (warps) per block
constexpr int F32_KEYS = 32;  // keys per tile: one per lane when scoring

template <int D, bool kBlock>
__global__ void __launch_bounds__(F32_ROWS * 32)
    flash_fwd_f32_kernel(Params p) {
  constexpr int DPL = D / 32;  // output columns per lane
  __shared__ float sQ[F32_ROWS][D];
  __shared__ float sK[F32_KEYS][D + 1];  // +1: lanes read distinct banks
  __shared__ float sV[F32_KEYS][D];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * F32_ROWS;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = q0 + warp;
  const int S = p.S;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int i = tid; i < F32_ROWS * D; i += F32_ROWS * 32) {
    const int r = i / D, d = i % D;
    sQ[r][d] = (q0 + r < S) ? qg[(q0 + r) * p.q_ss + d] : 0.f;
  }
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  const int k_end = p.causal ? min(S, q0 + F32_ROWS) : S;

  for (int k0 = 0; k0 < k_end; k0 += F32_KEYS) {
    __syncthreads();
    for (int i = tid; i < F32_KEYS * D; i += F32_ROWS * 32) {
      const int r = i / D, d = i % D, key = k0 + r;
      const bool ok = key < S;
      sK[r][d] = ok ? kg[key * p.k_ss + d] : 0.f;
      sV[r][d] = ok ? vg[key * p.v_ss + d] : 0.f;
    }
    __syncthreads();
    const int key = k0 + lane;
    float sc = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) sc = fmaf(sQ[warp][d], sK[lane][d], sc);
    sc *= p.scale;
    if (key >= S || (p.causal && key > row)) sc = -INFINITY;
    float mx = sc;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m, mx);
    const float mu = (m_new == -INFINITY) ? 0.f : m_new;
    const float pj = expf(sc - mu);
    const float corr = expf(m - mu);
    float ps = pj;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
    l = l * corr + ps;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= corr;
    for (int j = 0; j < F32_KEYS; ++j) {
      const float pk = __shfl_sync(0xffffffffu, pj, j);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] = fmaf(pk, sV[j][lane + 32 * i], acc[i]);
    }
    m = m_new;
  }
  if (row < S) {
    float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + row * p.o_ss;
    const long long at = static_cast<long long>(bh) * S + row;
    if constexpr (kBlock) {  // K4: acc unnormalized, m and l as they stand
#pragma unroll
      for (int i = 0; i < DPL; ++i) og[lane + 32 * i] = acc[i];
      if (lane == 0) {
        p.lse[at] = m;
        p.l[at] = l;
      }
    } else {
#pragma unroll
      for (int i = 0; i < DPL; ++i) og[lane + 32 * i] = acc[i] / l;
      if (lane == 0) p.lse[at] = m + logf(l);
    }
  }
}

template <int D, bool kBlock>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = (BM + 4 * BN) * (D + PAD) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D, kBlock>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + BM - 1) / BM, B * p.H);
  flash_fwd_bf16_kernel<D, kBlock><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool kBlock>
cudaError_t launch_f32(const Params& p, int B, cudaStream_t stream) {
  dim3 grid((p.S + F32_ROWS - 1) / F32_ROWS, B * p.H);
  flash_fwd_f32_kernel<D, kBlock><<<grid, F32_ROWS * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

template <bool kBlock>
int launch(const Params& p, int B, int D, int dtype, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128) err = launch_bf16<128, kBlock>(p, B, st);
  else if (dtype == 1 && D == 64) err = launch_bf16<64, kBlock>(p, B, st);
  else if (dtype == 0 && D == 128) err = launch_f32<128, kBlock>(p, B, st);
  else if (dtype == 0 && D == 64) err = launch_f32<64, kBlock>(p, B, st);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// C entry points, loaded with ctypes. Strides are in elements; the last
// dimension of every tensor is contiguous. dtype: 0 = float32, 1 = bf16.
// Each returns the CUDA error code of the launch (0 on success).

// K1: O [B, S, H, D] in the input dtype and lse [B*H, S] f32.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int S, int H, int KV, int D,
                         int dtype, long long q_sb, long long q_ss,
                         long long q_sh, long long k_sb, long long k_ss,
                         long long k_sh, long long v_sb, long long v_ss,
                         long long v_sh, long long o_sb, long long o_ss,
                         long long o_sh, float scale, int causal, int device,
                         void* stream) {
  Params p{q,    k,    v,    o,    static_cast<float*>(lse),
           nullptr, S, H,    KV,   q_sb,
           q_ss, q_sh, k_sb, k_ss, k_sh,
           v_sb, v_ss, v_sh, o_sb, o_ss,
           o_sh, scale, causal};
  return launch<false>(p, B, D, dtype, device, stream);
}

// K4: the f32 accumulator acc [B, S, H, D] and m, l [B*H, S] f32;
// causal = the same-shard diagonal mask.
extern "C" int flash_block_fwd(const void* q, const void* k, const void* v,
                               void* acc, void* m, void* l, int B, int S,
                               int H, int KV, int D, int dtype,
                               long long q_sb, long long q_ss, long long q_sh,
                               long long k_sb, long long k_ss, long long k_sh,
                               long long v_sb, long long v_ss, long long v_sh,
                               long long a_sb, long long a_ss, long long a_sh,
                               float scale, int causal, int device,
                               void* stream) {
  Params p{q,    k,    v,    acc,  static_cast<float*>(m),
           static_cast<float*>(l), S, H, KV, q_sb,
           q_ss, q_sh, k_sb, k_ss, k_sh,
           v_sb, v_ss, v_sh, a_sb, a_ss,
           a_sh, scale, causal};
  return launch<true>(p, B, D, dtype, device, stream);
}
