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
// A work item owns 64 keys of one (batch, kv head) and walks the q tiles of
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
// What the designs do about that bound. K3 is built for Hopper's full
// rate, on K1's machinery (csrc/hopper.cuh): wgmma with the sums in
// registers, fed by TMA through a ring of swizzled stages on mbarriers by
// a producer warp, persistent blocks (see its section below). K2 keeps the
// first design: every product on mma.sync m16n8k16 bf16 -> f32 with
// ldmatrix fetches, its 64 q rows' q and dO in shared memory while the key
// tiles stream through a two-stage cp.async pipeline, the score fragments
// turned into the next product's A operand in registers, the blocks with
// the most causal work launched first; its move onto K3's body is left to
// later work. Both skip tiles wholly past the diagonal. The float32 path
// (tests and the exact-gradient check, off the bf16 training path) uses
// plain FMA with one warp per row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tile_mma.cuh"

namespace {

using namespace hopper;
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
// K3, bf16: wgmma kernel, warp-specialised and persistent
// ---------------------------------------------------------------------------
//
// One block per SM walks the work items, (64 keys, batch and kv head), the
// earliest key blocks (the most causal work) first. Warpgroup 0 is the
// producer: one warp loads each item's K and V tiles, which stay in shared
// memory for the item, and streams the Q and dO tiles of 64 q rows of every
// q head of the kv head's GQA group (from the diagonal when causal) through
// a ring of KV_STAGES stages, all by TMA from 4D tensor maps over
// [B, S, heads, D] with the wrapper's strides (rows past S zero-filled);
// its lanes copy each tile's lse (in log2 units) and delta rows beside it.
// K and V, and each stage, have their own full and empty mbarriers, so the
// next item's tiles load while the consumer finishes the current one.
// Warpgroup 1 is the consumer, all 64 keys: per q tile it runs
// S^T = K Q^T and dP^T = V dO^T as wgmma m64n64k16 with both operands
// K-major in shared memory, forms P^T = exp(scale S^T - lse) and
// dS^T = P^T (dP^T - delta) scale in its registers, and runs
// dV += P^T dO and dK += dS^T Q as wgmma m64nDk16 with P^T and dS^T (in
// bf16) as the register operand and dO, Q MN-major (the transpose bit).
// dK and dV stay in registers over the item (D/2 f32 each a thread) and
// are written once in f32. One consumer warpgroup under
// __launch_bounds__(256, 1) may use up to 255 registers a thread: dK, dV,
// S^T and dP^T alone take 2 * D/2 + 64 = 192 at D 128 (239 in all, no
// spills). The tensor cores idle while it computes P^T and dS^T, but that
// work costs about 5 % (scripts/k3_controls.py): the m64n64 products
// themselves hold the kernel, and two consumer warpgroups under
// setmaxnreg, sharing or splitting the work, measured no faster.

constexpr int KV_BN = 64;          // keys of a work item
constexpr int KV_BM = 64;          // q rows of a streamed tile
constexpr int KV_STAGES = 3;       // of the Q / dO ring
constexpr int KV_THREADS = 256;    // producer and consumer warpgroups
constexpr int KV_BOX = 64 * 128;   // bytes of one [64 rows][64 d] box

template <int D>
constexpr int kv_smem_bytes() {  // tiles, lse and delta rows, barriers
  return 1024 + (2 + 2 * KV_STAGES) * (D / 64) * KV_BOX +
         2 * KV_STAGES * KV_BM * 4 + (2 + 2 * KV_STAGES) * 8;
}

template <int D>
__global__ void __launch_bounds__(KV_THREADS, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_g,
                               Params p, int bkv_count) {
  constexpr int TILE_BYTES = (D / 64) * KV_BOX;  // K, V, or a stage's Q, dO
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = align_1024(smem_raw);
  unsigned char* sV = sK + TILE_BYTES;
  unsigned char* sQ = sV + TILE_BYTES;              // [KV_STAGES]
  unsigned char* sG = sQ + KV_STAGES * TILE_BYTES;  // [KV_STAGES], dO
  float* sL = reinterpret_cast<float*>(sG + KV_STAGES * TILE_BYTES);
  float* sD = sL + KV_STAGES * KV_BM;  // [KV_STAGES][KV_BM] each
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(sD + KV_STAGES * KV_BM);
  uint64_t* empty_kv = full_kv + 1;
  uint64_t* full = full_kv + 2;         // [KV_STAGES]
  uint64_t* empty = full + KV_STAGES;   // [KV_STAGES]

  const int S = p.S, group = p.H / p.KV;
  const int n_qt = (S + KV_BM - 1) / KV_BM;
  const int n_items = (S + KV_BN - 1) / KV_BN * bkv_count;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    mbar_init(empty_kv, 1);  // the consumer's thread 0
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(&full[s], 32);  // every producer lane (lse, delta rows)
      mbar_init(&empty[s], 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one warp loads
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int it = 0;  // q tiles loaded so far, across items
    for (int i = blockIdx.x, j = 0; i < n_items; i += gridDim.x, ++j) {
      const int kb = i / bkv_count, bkv = i % bkv_count;
      const int b = bkv / p.KV, kvh = bkv % p.KV;
      if (lane == 0) {
        mbar_wait(empty_kv, (j & 1) ^ 1);
        mbar_arrive_expect_tx(full_kv, 2 * TILE_BYTES);
#pragma unroll
        for (int d = 0; d < D / 64; ++d) {
          tma_load_4d(sK + d * KV_BOX, &tm_k, full_kv, d * 64, kvh,
                      kb * KV_BN, b);
          tma_load_4d(sV + d * KV_BOX, &tm_v, full_kv, d * 64, kvh,
                      kb * KV_BN, b);
        }
      }
      const int first_qt = p.causal ? kb * KV_BN / KV_BM : 0;
      const int per_head = n_qt - first_qt;
      const int n_iter = group * per_head;  // K3's q tiles of this item
      for (int n = 0; n < n_iter; ++n, ++it) {
        const int st = it % KV_STAGES;
        mbar_wait(&empty[st], ((it / KV_STAGES) & 1) ^ 1);
        const int h = kvh * group + n / per_head;
        const int q0 = (first_qt + n % per_head) * KV_BM;
        const long long stat = static_cast<long long>(b * p.H + h) * S;
        for (int r = lane; r < KV_BM; r += 32) {
          const int row = q0 + r;
          sL[st * KV_BM + r] = row < S ? p.lse[stat + row] * kLog2e : 0.f;
          sD[st * KV_BM + r] = row < S ? p.delta[stat + row] : 0.f;
        }
        if (lane == 0) {  // its arrival, with the tiles' bytes
          mbar_arrive_expect_tx(&full[st], 2 * TILE_BYTES);
#pragma unroll
          for (int d = 0; d < D / 64; ++d) {
            tma_load_4d(sQ + st * TILE_BYTES + d * KV_BOX, &tm_q, &full[st],
                        d * 64, h, q0, b);
            tma_load_4d(sG + st * TILE_BYTES + d * KV_BOX, &tm_g, &full[st],
                        d * 64, h, q0, b);
          }
        } else {
          mbar_arrive(&full[st]);
        }
      }
    }
  } else {  // the consumer warpgroup: the item's 64 keys
    const int tid = threadIdx.x - 128, warp = tid / 32, lane = tid % 32;
    const int t4 = lane & 3;
    const float scale_log2 = p.scale * kLog2e;
    float sp[KV_BM / 2];   // S^T, then P^T: 64 keys x 64 q rows
    float dps[KV_BM / 2];  // dP^T, then dS^T
    uint32_t pa[KV_BM / 16][4], da[KV_BM / 16][4];  // their bf16 A operands
    float dk[D / 2], dv[D / 2];
    int it = 0;  // q tiles consumed so far, across items
    for (int i = blockIdx.x, j = 0; i < n_items; i += gridDim.x, ++j) {
      const int kb = i / bkv_count, bkv = i % bkv_count;
      const int b = bkv / p.KV, kvh = bkv % p.KV;
      const int k0 = kb * KV_BN;
      const int key_a = k0 + warp * 16 + lane / 4, key_b = key_a + 8;
      const int first_qt = p.causal ? kb * KV_BN / KV_BM : 0;
      const int per_head = n_qt - first_qt;
      const int n_iter = group * per_head;
#pragma unroll
      for (int e = 0; e < D / 2; ++e) dk[e] = dv[e] = 0.f;
      mbar_wait(full_kv, j & 1);

      for (int n = 0; n < n_iter; ++n, ++it) {
        const int st = it % KV_STAGES;
        mbar_wait(&full[st], (it / KV_STAGES) & 1);
        const unsigned char* cQ = sQ + st * TILE_BYTES;
        const unsigned char* cG = sG + st * TILE_BYTES;
        const float* cL = sL + st * KV_BM;
        const float* cD = sD + st * KV_BM;

        // S^T = K Q^T and dP^T = V dO^T, both operands K-major
        fence_operand(sp);
        fence_operand(dps);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int off = (kk / 4) * KV_BOX + (kk % 4) * 32;
          wgmma_m64n64k16_ss<0>(sp, desc_k_major(sK + off),
                                desc_k_major(cQ + off), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int off = (kk / 4) * KV_BOX + (kk % 4) * 32;
          wgmma_m64n64k16_ss<0>(dps, desc_k_major(sV + off),
                                desc_k_major(cG + off), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(sp);
        fence_operand(dps);

        // P^T = exp(scale S^T - lse), masked; dS^T = P^T (dP^T - delta)
        // scale; each rounded to bf16 as the next products' A operand
        // (accumulator layout = register A layout: q groups 2kk, 2kk + 1
        // form k16 step kk)
        const int q0 = (first_qt + n % per_head) * KV_BM;
        const bool masked =
            (q0 + KV_BM > S) || (p.causal && q0 < k0 + KV_BN);
#pragma unroll
        for (int jj = 0; jj < KV_BM / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = jj * 8 + t4 * 2 + (e & 1);
            float pv = fast_exp2(fmaf(sp[4 * jj + e], scale_log2, -cL[col]));
            if (masked) {
              const int qpos = q0 + col;
              const int key = (e >> 1) ? key_b : key_a;
              if (qpos >= S || (p.causal && qpos < key)) pv = 0.f;
            }
            sp[4 * jj + e] = pv;
            dps[4 * jj + e] = pv * (dps[4 * jj + e] - cD[col]) * p.scale;
          }
          pa[jj / 2][(jj & 1) * 2] = pack_bf16(sp[4 * jj], sp[4 * jj + 1]);
          pa[jj / 2][(jj & 1) * 2 + 1] =
              pack_bf16(sp[4 * jj + 2], sp[4 * jj + 3]);
          da[jj / 2][(jj & 1) * 2] = pack_bf16(dps[4 * jj], dps[4 * jj + 1]);
          da[jj / 2][(jj & 1) * 2 + 1] =
              pack_bf16(dps[4 * jj + 2], dps[4 * jj + 3]);
        }

        // dV += P^T dO and dK += dS^T Q: dO, Q [64 q][D] are B, MN-major
        fence_operand(dv);
        fence_operand(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KV_BM / 16; ++kk) {
          const uint64_t dg = desc_mn_major(cG + kk * 16 * 128, KV_BOX);
          if constexpr (D == 128)
            wgmma_m64n128k16_rs<1>(dv, pa[kk], dg, 1);
          else
            wgmma_m64n64k16_rs<1>(dv, pa[kk], dg, 1);
        }
#pragma unroll
        for (int kk = 0; kk < KV_BM / 16; ++kk) {
          const uint64_t dq = desc_mn_major(cQ + kk * 16 * 128, KV_BOX);
          if constexpr (D == 128)
            wgmma_m64n128k16_rs<1>(dk, da[kk], dq, 1);
          else
            wgmma_m64n64k16_rs<1>(dk, da[kk], dq, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(dv);
        fence_operand(dk);
        if (tid == 0) mbar_arrive(&empty[st]);  // the stage, read for good
      }
      if (tid == 0) mbar_arrive(empty_kv);  // K and V, read for good

      float* dkg = p.dk + b * p.dk_sb + kvh * p.dk_sh;
      float* dvg = p.dv + b * p.dk_sb + kvh * p.dk_sh;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int col = jj * 8 + t4 * 2;
        if (key_a < S) {
          *reinterpret_cast<float2*>(dkg + key_a * p.dk_ss + col) =
              make_float2(dk[4 * jj], dk[4 * jj + 1]);
          *reinterpret_cast<float2*>(dvg + key_a * p.dk_ss + col) =
              make_float2(dv[4 * jj], dv[4 * jj + 1]);
        }
        if (key_b < S) {
          *reinterpret_cast<float2*>(dkg + key_b * p.dk_ss + col) =
              make_float2(dk[4 * jj + 2], dk[4 * jj + 3]);
          *reinterpret_cast<float2*>(dvg + key_b * p.dk_ss + col) =
              make_float2(dv[4 * jj + 2], dv[4 * jj + 3]);
        }
      }
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

// The 4D tensor map of a [B, S, heads, D] bf16 tensor read through its
// element strides: boxes of 64 columns of one head and KV_BM rows.
cudaError_t make_rows_map(CUtensorMap* map, const void* base, int B, int S,
                          int heads, int D, long long sb, long long ss,
                          long long sh) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, KV_BM, 1};
  return make_map_bf16(map, base, 4, dims, strides, box);
}

// K3: in bf16 the tensor maps (encoding reads no device memory), then one
// persistent block per SM, at most one per work item; in f32 the FMA
// kernel.
template <int D>
cudaError_t launch_dkv(const Params& p, int B, int dtype, int device,
                       cudaStream_t st) {
  if (dtype != 1)
    return launch(flash_bwd_dkv_f32_kernel<D>,
                  dim3((p.S + F32_ROWS - 1) / F32_ROWS, B * p.KV),
                  F32_ROWS * 32, 0, p, st);
  CUtensorMap tm_q, tm_k, tm_v, tm_g;
  cudaError_t err = make_rows_map(&tm_q, p.q, B, p.S, p.H, D, p.q_sb,
                                  p.q_ss, p.q_sh);
  if (err == cudaSuccess)
    err = make_rows_map(&tm_k, p.k, B, p.S, p.KV, D, p.k_sb, p.k_ss, p.k_sh);
  if (err == cudaSuccess)
    err = make_rows_map(&tm_v, p.v, B, p.S, p.KV, D, p.v_sb, p.v_ss, p.v_sh);
  if (err == cudaSuccess)
    err = make_rows_map(&tm_g, p.g, B, p.S, p.H, D, p.g_sb, p.g_ss, p.g_sh);
  if (err != cudaSuccess) return err;
  constexpr int smem = kv_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int items = (p.S + KV_BN - 1) / KV_BN * B * p.KV;
  const int sms = sm_count(device);
  const int grid = items < sms ? items : sms;
  if (grid <= 0) return cudaErrorInvalidValue;
  flash_bwd_dkv_wgmma_kernel<D>
      <<<grid, KV_THREADS, smem, st>>>(tm_q, tm_k, tm_v, tm_g, p, B * p.KV);
  return cudaGetLastError();
}

cudaError_t dispatch(const Params& p, int B, int D, int dtype, bool dq,
                     int device, cudaStream_t st) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (B == 0 || p.S == 0 || p.H == 0) return cudaSuccess;
  if (D == 128) return dq ? launch_dq<128>(p, B, dtype, st)
                          : launch_dkv<128>(p, B, dtype, device, st);
  if (D == 64) return dq ? launch_dq<64>(p, B, dtype, st)
                         : launch_dkv<64>(p, B, dtype, device, st);
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
      dispatch(p, B, D, dtype, dq, device, static_cast<cudaStream_t>(stream)));
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

// The dynamic shared memory of one bf16 K3 block at head dim D, in bytes.
extern "C" int flash_bwd_dkv_smem_bytes(int D) {
  return D == 128 ? kv_smem_bytes<128>() : kv_smem_bytes<64>();
}
