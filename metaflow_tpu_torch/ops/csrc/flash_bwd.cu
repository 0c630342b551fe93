// Flash attention backward for Hopper (sm_90a): the gradients of q, k and v
// recomputed tile by tile from the saved lse, never writing the S x S score
// or probability matrix to device memory.
//
// K2, flash_bwd_dq, replaces the TPU kernel `_flash_bwd_dq_kernel` of
// metaflow_tpu/ops/attention.py (launched in `flash_block_bwd`):
//   dq = sum over keys of dS K,  dS = P (dO V^T - delta) scale,
//   P = exp(scale q k^T - lse)  (recomputed; natural-log lse, as K1 saves it).
// One block owns 64 q rows of one (batch, q head) and walks the key tiles,
// up to the diagonal when causal.
//
// K3, flash_bwd_dkv, replaces `_flash_bwd_dkv_kernel`:
//   dv = sum over queries of P^T dO,  dk = sum over queries of dS^T q.
// One block owns 64 keys of one (batch, kv head) and walks the q tiles of
// every q head of that kv head's GQA group, from the diagonal when causal.
// The group sum that the JAX package gets from the transpose of its kv-head
// repeat happens here in the f32 accumulators: no per-q-head buffer, no
// atomics, and dk, dv come out as [B, S, KV, D].
//
// Rounding points are the reference's: f32 scores scaled after the product,
// dP = dO V^T from bf16 operands with f32 accumulation, dS rounded to bf16
// before dS K (K2) and dS^T q (K3), P rounded to bf16 before P^T dO (K3).
// dq, dk and dv accumulate in f32 and are written in f32; the caller casts
// them to the input dtype once. Inputs are read through their strides (last
// dimension contiguous); lse and delta are [B*H, S] f32.
//
// Bound at the training shape (B=8, S=2048, H=16, KV=8, D=128, bf16,
// causal; 2,098,176 live (q, k) pairs per head): K2 does three products,
// 6*D flop per pair = 206.3 GFLOP = 0.209 ms at 989 TFLOP/s; K3 four,
// 8*D = 275.0 GFLOP = 0.278 ms. Their bytes (q, k, v, dO read once, lse,
// delta, the f32 gradients written once) are about 0.3 GB each, 0.1 ms at
// 3.35 TB/s, so both are bound by operations. The training step launches
// each once per layer (16 times for bench_1b).
//
// What the design does about that bound: every product runs on the tensor
// cores (mma.sync m16n8k16 bf16 -> f32, operands fetched with ldmatrix);
// the tile a block owns stays in shared memory (K2: q and dO; K3: k and v)
// while the other side streams through a two-stage cp.async pipeline; the
// score and probability fragments are turned into the next product's A
// operand in registers; tiles wholly past the diagonal are skipped and the
// blocks with the most causal work are launched first. wgmma, TMA and warp
// specialisation are left to later work. The float32 path (tests and the
// exact-gradient check, off the bf16 training path) uses plain FMA with one
// warp per row.

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
  const void* g;  // dO, laid out as q
  const float* lse;
  const float* delta;
  float* dq;  // [B, S, H, D]
  float* dk;  // [B, S, KV, D]
  float* dv;  // strides of dk
  int S, H, KV;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long g_sb, g_ss, g_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  float scale;
  int causal;
};

constexpr int NTHREADS = 128;  // four warps, 16 rows each

// ---------------------------------------------------------------------------
// K2, bf16: dq for 64 q rows, keys streamed in tiles of 32
// ---------------------------------------------------------------------------

constexpr int DQ_BM = 64;
constexpr int DQ_BN = 32;

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dq_bf16_kernel(Params p) {
  constexpr int LD = D + PAD;
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sG = sQ + DQ_BM * LD;
  __nv_bfloat16* sK = sG + DQ_BM * LD;      // [2][DQ_BN][LD]
  __nv_bfloat16* sV = sK + 2 * DQ_BN * LD;  // [2][DQ_BN][LD]

  const int qb = gridDim.x - 1 - blockIdx.x;  // most causal work first
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = qb * DQ_BM;
  const int S = p.S;

  const __nv_bfloat16* qg =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* gg =
      static_cast<const __nv_bfloat16*>(p.g) + b * p.g_sb + h * p.g_sh;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int c = tid; c < DQ_BM * CPR; c += NTHREADS) {
    const int r = c / CPR, col = (c % CPR) * 8, row = q0 + r;
    const bool ok = row < S;
    const long long rr = ok ? row : 0;
    cp_async_16(sQ + r * LD + col, qg + rr * p.q_ss + col, ok);
    cp_async_16(sG + r * LD + col, gg + rr * p.g_ss + col, ok);
  }
  auto load_kv = [&](int tile, int stage) {
    __nv_bfloat16* dK = sK + stage * DQ_BN * LD;
    __nv_bfloat16* dV = sV + stage * DQ_BN * LD;
    for (int c = tid; c < DQ_BN * CPR; c += NTHREADS) {
      const int r = c / CPR, col = (c % CPR) * 8, row = tile * DQ_BN + r;
      const bool ok = row < S;
      const long long rr = ok ? row : 0;
      cp_async_16(dK + r * LD + col, kg + rr * p.k_ss + col, ok);
      cp_async_16(dV + r * LD + col, vg + rr * p.v_ss + col, ok);
    }
  };

  int n_tiles = (S + DQ_BN - 1) / DQ_BN;
  if (p.causal) n_tiles = min(n_tiles, (q0 + DQ_BM + DQ_BN - 1) / DQ_BN);
  load_kv(0, 0);
  cp_async_commit();

  const float scale_log2 = p.scale * kLog2e;
  const int row_a = q0 + warp * 16 + g;  // this thread's two rows
  const int row_b = row_a + 8;
  const long long stat = static_cast<long long>(bh) * S;
  const float lse2[2] = {row_a < S ? p.lse[stat + row_a] * kLog2e : 0.f,
                         row_b < S ? p.lse[stat + row_b] * kLog2e : 0.f};
  const float dlt[2] = {row_a < S ? p.delta[stat + row_a] : 0.f,
                        row_b < S ? p.delta[stat + row_b] : 0.f};

  uint32_t qf[D / 16][4], gf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

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
      for (int kk = 0; kk < D / 16; ++kk) {
        load_a(qf[kk], sQ, LD, warp * 16, kk * 16, lane);
        load_a(gf[kk], sG, LD, warp * 16, kk * 16, lane);
      }
    }
    const __nv_bfloat16* cK = sK + (t & 1) * DQ_BN * LD;
    const __nv_bfloat16* cV = sV + (t & 1) * DQ_BN * LD;

    // s = q k^T and dp = dO v^T for this warp's 16 rows x DQ_BN keys
    float s[DQ_BN / 8][4], dp[DQ_BN / 8][4];
#pragma unroll
    for (int j = 0; j < DQ_BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < DQ_BN / 16; ++np) {
        uint32_t bk[4], bv[4];
        load_b_nk(bk, cK, LD, np * 16, kk * 16, lane);
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
        load_b_nk(bv, cV, LD, np * 16, kk * 16, lane);
        mma_bf16(dp[2 * np], gf[kk], bv[0], bv[1]);
        mma_bf16(dp[2 * np + 1], gf[kk], bv[2], bv[3]);
      }
    }

    // p = exp(scale s - lse), masked; ds = p (dp - delta) scale, kept in s
    const int k0 = t * DQ_BN;
    const bool masked =
        (k0 + DQ_BN > S) || (p.causal && k0 + DQ_BN - 1 > q0 + warp * 16);
#pragma unroll
    for (int j = 0; j < DQ_BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float pv = exp2f(fmaf(s[j][e], scale_log2, -lse2[i]));
        if (masked) {
          const int key = k0 + j * 8 + t4 * 2 + (e & 1);
          const int row = i ? row_b : row_a;
          if (key >= S || (p.causal && key > row)) pv = 0.f;
        }
        s[j][e] = pv * (dp[j][e] - dlt[i]) * p.scale;
      }
    }

    // dq += ds k, ds rounded to bf16
#pragma unroll
    for (int kk = 0; kk < DQ_BN / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t bk[4];
        load_b_kn(bk, cK, LD, kk * 16, dp2 * 16, lane);
        mma_bf16(acc[2 * dp2], a, bk[0], bk[1]);
        mma_bf16(acc[2 * dp2 + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

  float* dqg = p.dq + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + t4 * 2;
    if (row_a < S)
      *reinterpret_cast<float2*>(dqg + row_a * p.dq_ss + col) =
          make_float2(acc[n][0], acc[n][1]);
    if (row_b < S)
      *reinterpret_cast<float2*>(dqg + row_b * p.dq_ss + col) =
          make_float2(acc[n][2], acc[n][3]);
  }
}

// ---------------------------------------------------------------------------
// K3, bf16: dk, dv for 64 keys, q tiles of 32 streamed over the GQA group
// ---------------------------------------------------------------------------

constexpr int DKV_BN = 64;
constexpr int DKV_BM = 32;

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkv_bf16_kernel(Params p) {
  constexpr int LD = D + PAD;
  constexpr int CPR = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + DKV_BN * LD;
  __nv_bfloat16* sQ = sV + DKV_BN * LD;      // [2][DKV_BM][LD]
  __nv_bfloat16* sG = sQ + 2 * DKV_BM * LD;  // [2][DKV_BM][LD]
  float* sL = reinterpret_cast<float*>(sG + 2 * DKV_BM * LD);  // [2][BM]
  float* sD = sL + 2 * DKV_BM;                                 // [2][BM]

  const int kb = blockIdx.x;  // key tile 0 has the most causal work
  const int bkv = blockIdx.y;
  const int b = bkv / p.KV, kvh = bkv % p.KV;
  const int group = p.H / p.KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = kb * DKV_BN;
  const int S = p.S;

  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  for (int c = tid; c < DKV_BN * CPR; c += NTHREADS) {
    const int r = c / CPR, col = (c % CPR) * 8, row = k0 + r;
    const bool ok = row < S;
    const long long rr = ok ? row : 0;
    cp_async_16(sK + r * LD + col, kg + rr * p.k_ss + col, ok);
    cp_async_16(sV + r * LD + col, vg + rr * p.v_ss + col, ok);
  }

  const int first_qt = p.causal ? k0 / DKV_BM : 0;
  const int n_qt = (S + DKV_BM - 1) / DKV_BM;
  const int per_head = n_qt - first_qt;
  const int n_iter = group * per_head;

  // iteration it: q head kvh * group + it / per_head, q tile
  // first_qt + it % per_head
  auto load_q = [&](int it, int stage) {
    const int h = kvh * group + it / per_head;
    const int q0 = (first_qt + it % per_head) * DKV_BM;
    const __nv_bfloat16* qg =
        static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* gg =
        static_cast<const __nv_bfloat16*>(p.g) + b * p.g_sb + h * p.g_sh;
    __nv_bfloat16* dQ = sQ + stage * DKV_BM * LD;
    __nv_bfloat16* dG = sG + stage * DKV_BM * LD;
    for (int c = tid; c < DKV_BM * CPR; c += NTHREADS) {
      const int r = c / CPR, col = (c % CPR) * 8, row = q0 + r;
      const bool ok = row < S;
      const long long rr = ok ? row : 0;
      cp_async_16(dQ + r * LD + col, qg + rr * p.q_ss + col, ok);
      cp_async_16(dG + r * LD + col, gg + rr * p.g_ss + col, ok);
    }
    // lse (in log2 units) and delta; rows past S are masked below
    const long long stat = static_cast<long long>(b * p.H + h) * S;
    if (tid < 2 * DKV_BM) {
      const int r = tid % DKV_BM, row = q0 + r;
      const bool ok = row < S;
      if (tid < DKV_BM)
        sL[stage * DKV_BM + r] = ok ? p.lse[stat + row] * kLog2e : 0.f;
      else
        sD[stage * DKV_BM + r] = ok ? p.delta[stat + row] : 0.f;
    }
  };

  const float scale_log2 = p.scale * kLog2e;
  const int key_a = k0 + warp * 16 + g;  // this thread's two keys
  const int key_b = key_a + 8;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  if (n_iter > 0) load_q(0, 0);
  cp_async_commit();  // with the k, v tile
  for (int it = 0; it < n_iter; ++it) {
    if (it + 1 < n_iter) {
      load_q(it + 1, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (first_qt + it % per_head) * DKV_BM;
    const __nv_bfloat16* cQ = sQ + (it & 1) * DKV_BM * LD;
    const __nv_bfloat16* cG = sG + (it & 1) * DKV_BM * LD;
    const float* cL = sL + (it & 1) * DKV_BM;
    const float* cD = sD + (it & 1) * DKV_BM;

    // s^T = k q^T and dp^T = v dO^T for this warp's 16 keys x DKV_BM rows
    float st[DKV_BM / 8][4], dpt[DKV_BM / 8][4];
#pragma unroll
    for (int j = 0; j < DKV_BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, sK, LD, warp * 16, kk * 16, lane);
      load_a(va, sV, LD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < DKV_BM / 16; ++np) {
        uint32_t bq[4], bg[4];
        load_b_nk(bq, cQ, LD, np * 16, kk * 16, lane);
        mma_bf16(st[2 * np], ka, bq[0], bq[1]);
        mma_bf16(st[2 * np + 1], ka, bq[2], bq[3]);
        load_b_nk(bg, cG, LD, np * 16, kk * 16, lane);
        mma_bf16(dpt[2 * np], va, bg[0], bg[1]);
        mma_bf16(dpt[2 * np + 1], va, bg[2], bg[3]);
      }
    }

    // p^T = exp(scale s^T - lse), masked (kept in st);
    // ds^T = p^T (dp^T - delta) scale (kept in dpt)
    const bool masked =
        (q0 + DKV_BM > S) || (p.causal && q0 < k0 + warp * 16 + 15);
#pragma unroll
    for (int j = 0; j < DKV_BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t4 * 2 + (e & 1);
        float pv = exp2f(fmaf(st[j][e], scale_log2, -cL[col]));
        if (masked) {
          const int qpos = q0 + col;
          const int key = (e >> 1) ? key_b : key_a;
          if (qpos >= S || (p.causal && qpos < key)) pv = 0.f;
        }
        st[j][e] = pv;
        dpt[j][e] = pv * (dpt[j][e] - cD[col]) * p.scale;
      }
    }

    // dv += p^T dO with p rounded to bf16; dk += ds^T q with ds rounded
#pragma unroll
    for (int kk = 0; kk < DKV_BM / 16; ++kk) {
      uint32_t ap[4], ad[4];
      c_to_a(ap, st[2 * kk], st[2 * kk + 1]);
      c_to_a(ad, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int dp2 = 0; dp2 < D / 16; ++dp2) {
        uint32_t bg[4], bq[4];
        load_b_kn(bg, cG, LD, kk * 16, dp2 * 16, lane);
        mma_bf16(dv[2 * dp2], ap, bg[0], bg[1]);
        mma_bf16(dv[2 * dp2 + 1], ap, bg[2], bg[3]);
        load_b_kn(bq, cQ, LD, kk * 16, dp2 * 16, lane);
        mma_bf16(dk[2 * dp2], ad, bq[0], bq[1]);
        mma_bf16(dk[2 * dp2 + 1], ad, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }
  if (n_iter == 0) cp_async_wait<0>();

  float* dkg = p.dk + b * p.dk_sb + kvh * p.dk_sh;
  float* dvg = p.dv + b * p.dk_sb + kvh * p.dk_sh;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + t4 * 2;
    if (key_a < S) {
      *reinterpret_cast<float2*>(dkg + key_a * p.dk_ss + col) =
          make_float2(dk[n][0], dk[n][1]);
      *reinterpret_cast<float2*>(dvg + key_a * p.dk_ss + col) =
          make_float2(dv[n][0], dv[n][1]);
    }
    if (key_b < S) {
      *reinterpret_cast<float2*>(dkg + key_b * p.dk_ss + col) =
          make_float2(dk[n][2], dk[n][3]);
      *reinterpret_cast<float2*>(dvg + key_b * p.dk_ss + col) =
          make_float2(dv[n][2], dv[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// float32 kernels: one warp per row, FMA only
// ---------------------------------------------------------------------------

constexpr int F32_ROWS = 8;   // rows (warps) per block
constexpr int F32_TILE = 32;  // streamed rows per tile: one per lane

// K2, f32: one warp per q row; lane j scores key k0 + j.
template <int D>
__global__ void __launch_bounds__(F32_ROWS * 32)
    flash_bwd_dq_f32_kernel(Params p) {
  constexpr int DPL = D / 32;  // output columns per lane
  __shared__ float sQ[F32_ROWS][D];
  __shared__ float sG[F32_ROWS][D];
  __shared__ float sK[F32_TILE][D + 1];  // +1: lanes read distinct banks
  __shared__ float sV[F32_TILE][D + 1];

  const int q0 = (gridDim.x - 1 - blockIdx.x) * F32_ROWS;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = q0 + warp;
  const int S = p.S;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* gg = static_cast<const float*>(p.g) + b * p.g_sb + h * p.g_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int i = tid; i < F32_ROWS * D; i += F32_ROWS * 32) {
    const int r = i / D, d = i % D;
    const bool ok = q0 + r < S;
    sQ[r][d] = ok ? qg[(q0 + r) * p.q_ss + d] : 0.f;
    sG[r][d] = ok ? gg[(q0 + r) * p.g_ss + d] : 0.f;
  }
  const long long stat = static_cast<long long>(bh) * S;
  const float lse = row < S ? p.lse[stat + row] : 0.f;
  const float dlt = row < S ? p.delta[stat + row] : 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  const int k_end = p.causal ? min(S, q0 + F32_ROWS) : S;

  for (int k0 = 0; k0 < k_end; k0 += F32_TILE) {
    __syncthreads();
    for (int i = tid; i < F32_TILE * D; i += F32_ROWS * 32) {
      const int r = i / D, d = i % D, key = k0 + r;
      const bool ok = key < S;
      sK[r][d] = ok ? kg[key * p.k_ss + d] : 0.f;
      sV[r][d] = ok ? vg[key * p.v_ss + d] : 0.f;
    }
    __syncthreads();
    const int key = k0 + lane;
    float sc = 0.f, dpv = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      sc = fmaf(sQ[warp][d], sK[lane][d], sc);
      dpv = fmaf(sG[warp][d], sV[lane][d], dpv);
    }
    float pv = expf(sc * p.scale - lse);
    if (key >= S || (p.causal && key > row)) pv = 0.f;
    const float ds = pv * (dpv - dlt) * p.scale;
    for (int j = 0; j < F32_TILE; ++j) {
      const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
      for (int i = 0; i < DPL; ++i)
        acc[i] = fmaf(dsj, sK[j][lane + 32 * i], acc[i]);
    }
  }
  if (row < S) {
    float* out = p.dq + b * p.dq_sb + h * p.dq_sh + row * p.dq_ss;
#pragma unroll
    for (int i = 0; i < DPL; ++i) out[lane + 32 * i] = acc[i];
  }
}

// K3, f32: one warp per key; lane j handles q row q0 + j of each q tile of
// every q head in the key's GQA group.
template <int D>
__global__ void __launch_bounds__(F32_ROWS * 32)
    flash_bwd_dkv_f32_kernel(Params p) {
  constexpr int DPL = D / 32;
  __shared__ float sK[F32_ROWS][D];
  __shared__ float sV[F32_ROWS][D];
  __shared__ float sQ[F32_TILE][D + 1];
  __shared__ float sG[F32_TILE][D + 1];
  __shared__ float sL[F32_TILE];
  __shared__ float sD[F32_TILE];

  const int k0 = blockIdx.x * F32_ROWS;
  const int bkv = blockIdx.y;
  const int b = bkv / p.KV, kvh = bkv % p.KV;
  const int group = p.H / p.KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int key = k0 + warp;
  const int S = p.S;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  for (int i = tid; i < F32_ROWS * D; i += F32_ROWS * 32) {
    const int r = i / D, d = i % D;
    const bool ok = k0 + r < S;
    sK[r][d] = ok ? kg[(k0 + r) * p.k_ss + d] : 0.f;
    sV[r][d] = ok ? vg[(k0 + r) * p.v_ss + d] : 0.f;
  }
  float dk[DPL], dv[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) dk[i] = dv[i] = 0.f;
  const int q_start = p.causal ? (k0 / F32_TILE) * F32_TILE : 0;

  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const float* qg =
        static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* gg =
        static_cast<const float*>(p.g) + b * p.g_sb + h * p.g_sh;
    const long long stat = static_cast<long long>(b * p.H + h) * S;
    for (int q0 = q_start; q0 < S; q0 += F32_TILE) {
      __syncthreads();
      for (int i = tid; i < F32_TILE * D; i += F32_ROWS * 32) {
        const int r = i / D, d = i % D, row = q0 + r;
        const bool ok = row < S;
        sQ[r][d] = ok ? qg[row * p.q_ss + d] : 0.f;
        sG[r][d] = ok ? gg[row * p.g_ss + d] : 0.f;
      }
      if (tid < F32_TILE) {
        const bool ok = q0 + tid < S;
        sL[tid] = ok ? p.lse[stat + q0 + tid] : 0.f;
        sD[tid] = ok ? p.delta[stat + q0 + tid] : 0.f;
      }
      __syncthreads();
      const int qpos = q0 + lane;
      float sc = 0.f, dpv = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        sc = fmaf(sQ[lane][d], sK[warp][d], sc);
        dpv = fmaf(sG[lane][d], sV[warp][d], dpv);
      }
      float pv = expf(sc * p.scale - sL[lane]);
      if (qpos >= S || (p.causal && qpos < key)) pv = 0.f;
      const float ds = pv * (dpv - sD[lane]) * p.scale;
      for (int j = 0; j < F32_TILE; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pv, j);
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          dv[i] = fmaf(pj, sG[j][lane + 32 * i], dv[i]);
          dk[i] = fmaf(dsj, sQ[j][lane + 32 * i], dk[i]);
        }
      }
    }
  }
  if (key < S) {
    float* dko = p.dk + b * p.dk_sb + kvh * p.dk_sh + key * p.dk_ss;
    float* dvo = p.dv + b * p.dk_sb + kvh * p.dk_sh + key * p.dk_ss;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      dko[lane + 32 * i] = dk[i];
      dvo[lane + 32 * i] = dv[i];
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem,
                   const Params& p, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Params& p, int B, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    constexpr int smem = (2 * DQ_BM + 4 * DQ_BN) * (D + PAD) * 2;
    return launch(flash_bwd_dq_bf16_kernel<D>,
                  dim3((p.S + DQ_BM - 1) / DQ_BM, B * p.H), NTHREADS, smem,
                  p, st);
  }
  return launch(flash_bwd_dq_f32_kernel<D>,
                dim3((p.S + F32_ROWS - 1) / F32_ROWS, B * p.H),
                F32_ROWS * 32, 0, p, st);
}

template <int D>
cudaError_t launch_dkv(const Params& p, int B, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    constexpr int smem =
        (2 * DKV_BN + 4 * DKV_BM) * (D + PAD) * 2 + 4 * DKV_BM * 4;
    return launch(flash_bwd_dkv_bf16_kernel<D>,
                  dim3((p.S + DKV_BN - 1) / DKV_BN, B * p.KV), NTHREADS,
                  smem, p, st);
  }
  return launch(flash_bwd_dkv_f32_kernel<D>,
                dim3((p.S + F32_ROWS - 1) / F32_ROWS, B * p.KV),
                F32_ROWS * 32, 0, p, st);
}

cudaError_t dispatch(const Params& p, int B, int D, int dtype, bool dq,
                     cudaStream_t st) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (D == 128) return dq ? launch_dq<128>(p, B, dtype, st)
                          : launch_dkv<128>(p, B, dtype, st);
  if (D == 64) return dq ? launch_dq<64>(p, B, dtype, st)
                         : launch_dkv<64>(p, B, dtype, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// C entry points, loaded with ctypes. Strides are in elements; the last
// dimension of every tensor is contiguous. dtype: 0 = float32, 1 = bf16.
// `out` holds dq (flash_bwd_dq) or dk then dv (flash_bwd_dkv), all f32 with
// the strides out_sb, out_ss, out_sh. Each returns the CUDA error code of
// its launch (0 on success).
#define FLASH_BWD_ARGS                                                       \
  const void *q, const void *k, const void *v, const void *g,               \
      const void *lse, const void *delta, void *out0, void *out1, int B,     \
      int S, int H, int KV, int D, int dtype, long long q_sb, long long q_ss, \
      long long q_sh, long long k_sb, long long k_ss, long long k_sh,         \
      long long v_sb, long long v_ss, long long v_sh, long long g_sb,         \
      long long g_ss, long long g_sh, long long out_sb, long long out_ss,     \
      long long out_sh, float scale, int causal, int device, void *stream

static int run(FLASH_BWD_ARGS, bool dq) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.g = g;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  if (dq) {
    p.dq = static_cast<float*>(out0);
    p.dq_sb = out_sb, p.dq_ss = out_ss, p.dq_sh = out_sh;
  } else {
    p.dk = static_cast<float*>(out0);
    p.dv = static_cast<float*>(out1);
    p.dk_sb = out_sb, p.dk_ss = out_ss, p.dk_sh = out_sh;
  }
  p.S = S, p.H = H, p.KV = KV;
  p.q_sb = q_sb, p.q_ss = q_ss, p.q_sh = q_sh;
  p.k_sb = k_sb, p.k_ss = k_ss, p.k_sh = k_sh;
  p.v_sb = v_sb, p.v_ss = v_ss, p.v_sh = v_sh;
  p.g_sb = g_sb, p.g_ss = g_ss, p.g_sh = g_sh;
  p.scale = scale;
  p.causal = causal;
  return static_cast<int>(
      dispatch(p, B, D, dtype, dq, static_cast<cudaStream_t>(stream)));
}

extern "C" int flash_bwd_dq(FLASH_BWD_ARGS) {
  return run(q, k, v, g, lse, delta, out0, out1, B, S, H, KV, D, dtype, q_sb,
             q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss,
             g_sh, out_sb, out_ss, out_sh, scale, causal, device, stream,
             true);
}

extern "C" int flash_bwd_dkv(FLASH_BWD_ARGS) {
  return run(q, k, v, g, lse, delta, out0, out1, B, S, H, KV, D, dtype, q_sb,
             q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss,
             g_sh, out_sb, out_ss, out_sh, scale, causal, device, stream,
             false);
}
