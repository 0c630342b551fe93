// Flash attention backward for Hopper (sm_90a): the gradients of q, k and v
// recomputed tile by tile from the saved lse, never writing the S x S score
// or probability matrix to device memory.
//
// K2, flash_bwd_dq, replaces the TPU kernel `_flash_bwd_dq_kernel` of
// metaflow_tpu/ops/attention.py (launched in `flash_block_bwd`):
//   dq = sum over keys of dS K,  dS = P (dO V^T - delta) scale,
//   P = exp(scale q k^T - lse)  (recomputed; natural-log lse, as K1 saves it).
// A work item owns 128 q rows of one (batch, q head) and walks the key
// tiles of its kv head, up to the diagonal when causal.
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
// What the designs do about that bound. Both bf16 kernels are built for
// Hopper's full rate on K1's machinery (csrc/hopper.cuh): wgmma with the
// sums in registers, fed by TMA through a ring of swizzled stages on
// mbarriers by a producer warp, persistent blocks with the most causal work
// first (see their sections below). K3 holds its keys and streams the q
// tiles; K2 holds its q rows and dO and streams the key tiles, with two
// consumer warpgroups sharing each stage. In both the score fragments
// become the next product's register A operand, and tiles wholly past the
// diagonal are skipped. The float32 path (tests and the exact-gradient
// check, off the bf16 training path) uses plain FMA with one warp per row.

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
// K2, bf16: wgmma kernel on K3's machinery, warp-specialised and persistent
// ---------------------------------------------------------------------------
//
// One block per SM walks the work items, (128 q rows, batch and q head),
// the latest q blocks (the most causal work) first. Warpgroup 0 is the
// producer: one warp loads each item's Q and dO, which stay in shared
// memory for the item, and its lanes copy the item's lse (in log2 units)
// and delta rows beside them; lane 0 streams the K and V tiles of 64 keys
// of the item's kv head (up to the diagonal when causal) through a ring of
// DQ_STAGES stages that runs on across items, all by TMA from the 4D tensor
// maps of K3 (Q and dO in boxes of 128 rows, so no box starts past S). Q
// with dO, and each stage, have their own full and empty mbarriers, so the
// next item's rows and first tiles load while the consumers finish the
// current one. Warpgroups 1 and 2 are the consumers, 64 q rows each, both
// reading every stage. Per key tile a consumer runs S = Q K^T and
// dP = dO V^T as wgmma m64n64k16 with both operands K-major in shared
// memory, forms P = exp(scale S - lse) and dS = P (dP - delta) scale in its
// registers, rounds dS to bf16 as the register A operand and runs
// dq += dS K as wgmma m64nDk16 with K MN-major (the transpose bit), as K3
// runs dK += dS^T Q. dq stays in f32 registers over the item (D/2 a
// thread) and is written once. Under causal masking a consumer skips the
// products of a tile wholly past its rows (the item's last tile, for
// consumer 0), and only a tile that reaches past the diagonal or past S is
// masked. Registers: dq, S, dP and the dS operand take D/2 + 80 a thread
// (144 at D 128) under setmaxnreg's 232; shared memory holds Q and dO
// [128][D] and the K, V stages [64][D] (199 KB at D 128).

constexpr int DQ_BM = 128;         // q rows of a work item, 64 a consumer
constexpr int DQ_BN = 64;          // keys of a streamed K / V tile
constexpr int DQ_STAGES = 4;       // of the K / V ring
constexpr int DQ_THREADS = 384;    // producer and two consumer warpgroups
constexpr int DQ_QBOX = DQ_BM * 128;  // bytes of one [128 rows][64 d] box

template <int D>
constexpr int dq_smem_bytes() {  // Q, dO, the stages, lse, delta, barriers
  return 1024 + 2 * (D / 64) * DQ_QBOX + 2 * DQ_STAGES * (D / 64) * KV_BOX +
         2 * DQ_BM * 4 + (2 + 2 * DQ_STAGES) * 8;
}

template <int D>
__global__ void __launch_bounds__(DQ_THREADS, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_g,
                              Params p, int bh_count) {
  constexpr int ROWS_BYTES = (D / 64) * DQ_QBOX;  // Q or dO, 128 rows
  constexpr int TILE_BYTES = (D / 64) * KV_BOX;   // a K or V tile, 64 keys
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);
  unsigned char* sG = sQ + ROWS_BYTES;              // dO
  unsigned char* sK = sG + ROWS_BYTES;              // [DQ_STAGES]
  unsigned char* sV = sK + DQ_STAGES * TILE_BYTES;  // [DQ_STAGES]
  float* sL = reinterpret_cast<float*>(sV + DQ_STAGES * TILE_BYTES);
  float* sD = sL + DQ_BM;  // [DQ_BM] each
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sD + DQ_BM);
  uint64_t* empty_q = full_q + 1;
  uint64_t* full = full_q + 2;          // [DQ_STAGES]
  uint64_t* empty = full + DQ_STAGES;   // [DQ_STAGES]

  const int S = p.S, group = p.H / p.KV;
  const int n_qb = (S + DQ_BM - 1) / DQ_BM;
  const int n_items = n_qb * bh_count;
  const int all_tiles = (S + DQ_BN - 1) / DQ_BN;
  // the key tiles of the rows before `row_end`
  auto tiles_to = [&](int row_end) {
    return p.causal ? min(all_tiles, (row_end + DQ_BN - 1) / DQ_BN)
                    : all_tiles;
  };

  if (threadIdx.x == 0) {
    mbar_init(full_q, 32);  // every producer lane (lse, delta rows)
    mbar_init(empty_q, 2);  // one thread of each consumer
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup: one warp loads
    setmaxnreg_dec<40>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    int it = 0;  // key tiles loaded so far, across items
    for (int i = blockIdx.x, j = 0; i < n_items; i += gridDim.x, ++j) {
      int qb, bh;
      latest_q_block_first(i, n_qb, bh_count, qb, bh);
      const int b = bh / p.H, h = bh % p.H, kvh = h / group;
      const int q0 = qb * DQ_BM;
      mbar_wait(empty_q, (j & 1) ^ 1);
      const long long stat = static_cast<long long>(bh) * S;
      for (int r = lane; r < DQ_BM; r += 32) {
        const int row = q0 + r;
        sL[r] = row < S ? p.lse[stat + row] * kLog2e : 0.f;
        sD[r] = row < S ? p.delta[stat + row] : 0.f;
      }
      if (lane == 0) {  // its arrival, with the rows' bytes
        mbar_arrive_expect_tx(full_q, 2 * ROWS_BYTES);
#pragma unroll
        for (int d = 0; d < D / 64; ++d) {
          tma_load_4d(sQ + d * DQ_QBOX, &tm_q, full_q, d * 64, h, q0, b);
          tma_load_4d(sG + d * DQ_QBOX, &tm_g, full_q, d * 64, h, q0, b);
        }
      } else {
        mbar_arrive(full_q);
      }
      if (lane != 0) continue;
      const int n_tiles = tiles_to(q0 + DQ_BM);
      for (int t = 0; t < n_tiles; ++t, ++it) {
        const int st = it % DQ_STAGES;
        mbar_wait(&empty[st], ((it / DQ_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], 2 * TILE_BYTES);
#pragma unroll
        for (int d = 0; d < D / 64; ++d) {
          tma_load_4d(sK + st * TILE_BYTES + d * KV_BOX, &tm_k, &full[st],
                      d * 64, kvh, t * DQ_BN, b);
          tma_load_4d(sV + st * TILE_BYTES + d * KV_BOX, &tm_v, &full[st],
                      d * 64, kvh, t * DQ_BN, b);
        }
      }
    }
  } else {  // a consumer warpgroup: 64 q rows of each item
    setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t4 = lane & 3;
    const float scale_log2 = p.scale * kLog2e;
    const unsigned char* sQc = sQ + c * 64 * 128;  // rows c*64.. of each box
    const unsigned char* sGc = sG + c * 64 * 128;
    float sp[DQ_BN / 2];   // S: 64 q rows x 64 keys
    float dps[DQ_BN / 2];  // dP, then dS
    uint32_t da[DQ_BN / 16][4];  // dS in bf16: the A operand of dS K
    float dq[D / 2];
    int it = 0;  // key tiles consumed so far, across items
    for (int i = blockIdx.x, j = 0; i < n_items; i += gridDim.x, ++j) {
      int qb, bh;
      latest_q_block_first(i, n_qb, bh_count, qb, bh);
      const int b = bh / p.H, h = bh % p.H;
      const int q0 = qb * DQ_BM;
      const int first_row = q0 + c * 64 + warp * 16;  // this warp's
      const int row_a = first_row + lane / 4, row_b = row_a + 8;
      const int n_tiles = tiles_to(q0 + DQ_BM);
      const int my_tiles = tiles_to(q0 + c * 64 + 64);  // reach my rows
#pragma unroll
      for (int e = 0; e < D / 2; ++e) dq[e] = 0.f;
      mbar_wait(full_q, j & 1);
      const float lse2[2] = {sL[row_a - q0], sL[row_b - q0]};
      const float dlt[2] = {sD[row_a - q0], sD[row_b - q0]};

      for (int t = 0; t < n_tiles; ++t, ++it) {
        const int st = it % DQ_STAGES;
        mbar_wait(&full[st], (it / DQ_STAGES) & 1);
        if (t < my_tiles) {
          const unsigned char* cK = sK + st * TILE_BYTES;
          const unsigned char* cV = sV + st * TILE_BYTES;

          // S = Q K^T and dP = dO V^T, both operands K-major
          fence_operand(sp);
          fence_operand(dps);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const int a_off = (kk / 4) * DQ_QBOX + (kk % 4) * 32;
            const int b_off = (kk / 4) * KV_BOX + (kk % 4) * 32;
            wgmma_m64n64k16_ss<0>(sp, desc_k_major(sQc + a_off),
                                  desc_k_major(cK + b_off), kk > 0);
          }
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const int a_off = (kk / 4) * DQ_QBOX + (kk % 4) * 32;
            const int b_off = (kk / 4) * KV_BOX + (kk % 4) * 32;
            wgmma_m64n64k16_ss<0>(dps, desc_k_major(sGc + a_off),
                                  desc_k_major(cV + b_off), kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_operand(sp);
          fence_operand(dps);
          // Q, dO, lse and delta read for good after the last products
          if (t == my_tiles - 1 && tid == 0) mbar_arrive(empty_q);

          // P = exp(scale S - lse), masked; dS = P (dP - delta) scale,
          // rounded to bf16 as the next product's A operand (accumulator
          // layout = register A layout: key groups 2kk, 2kk + 1 form k16
          // step kk)
          const int k0 = t * DQ_BN;
          const bool masked =
              (k0 + DQ_BN > S) || (p.causal && k0 + DQ_BN - 1 > first_row);
#pragma unroll
          for (int jj = 0; jj < DQ_BN / 8; ++jj) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              float pv = fast_exp2(fmaf(sp[4 * jj + e], scale_log2, -lse2[r]));
              if (masked) {
                const int key = k0 + jj * 8 + t4 * 2 + (e & 1);
                const int qrow = r ? row_b : row_a;
                if (key >= S || (p.causal && key > qrow)) pv = 0.f;
              }
              dps[4 * jj + e] = pv * (dps[4 * jj + e] - dlt[r]) * p.scale;
            }
            da[jj / 2][(jj & 1) * 2] = pack_bf16(dps[4 * jj], dps[4 * jj + 1]);
            da[jj / 2][(jj & 1) * 2 + 1] =
                pack_bf16(dps[4 * jj + 2], dps[4 * jj + 3]);
          }

          // dq += dS K: K [64 keys][D] is B, MN-major
          fence_operand(dq);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DQ_BN / 16; ++kk) {
            const uint64_t kt = desc_mn_major(cK + kk * 16 * 128, KV_BOX);
            if constexpr (D == 128)
              wgmma_m64n128k16_rs<1>(dq, da[kk], kt, 1);
            else
              wgmma_m64n64k16_rs<1>(dq, da[kk], kt, 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_operand(dq);
        }
        if (tid == 0) mbar_arrive(&empty[st]);  // K, V of the stage, read
      }

      float* dqg = p.dq + b * p.dq_sb + h * p.dq_sh;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int col = jj * 8 + t4 * 2;
        if (row_a < S)
          *reinterpret_cast<float2*>(dqg + row_a * p.dq_ss + col) =
              make_float2(dq[4 * jj], dq[4 * jj + 1]);
        if (row_b < S)
          *reinterpret_cast<float2*>(dqg + row_b * p.dq_ss + col) =
              make_float2(dq[4 * jj + 2], dq[4 * jj + 3]);
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

// A float32 kernel on grid x F32_ROWS warps.
template <typename Kernel>
cudaError_t launch_f32(Kernel kernel, dim3 grid, const Params& p,
                       cudaStream_t stream) {
  kernel<<<grid, F32_ROWS * 32, 0, stream>>>(p);
  return cudaGetLastError();
}

// The 4D tensor map of a [B, S, heads, D] bf16 tensor read through its
// element strides: boxes of 64 columns of one head and `rows` rows.
cudaError_t make_rows_map(CUtensorMap* map, const void* base, int B, int S,
                          int heads, int D, long long sb, long long ss,
                          long long sh, int rows = KV_BM) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return make_map_bf16(map, base, 4, dims, strides, box);
}

// K3: in bf16 the tensor maps (encoding reads no device memory), then one
// persistent block per SM, at most one per work item; in f32 the FMA
// kernel.
template <int D>
cudaError_t launch_dkv(const Params& p, int B, int dtype, int device,
                       cudaStream_t st) {
  if (dtype != 1)
    return launch_f32(flash_bwd_dkv_f32_kernel<D>,
                      dim3((p.S + F32_ROWS - 1) / F32_ROWS, B * p.KV), p, st);
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

// K2: in bf16 the tensor maps (Q and dO in boxes of DQ_BM rows, K and V of
// DQ_BN), then one persistent block per SM, at most one per work item; in
// f32 the FMA kernel.
template <int D>
cudaError_t launch_dq(const Params& p, int B, int dtype, int device,
                      cudaStream_t st) {
  if (dtype != 1)
    return launch_f32(flash_bwd_dq_f32_kernel<D>,
                      dim3((p.S + F32_ROWS - 1) / F32_ROWS, B * p.H), p, st);
  static_assert(DQ_BN == KV_BM, "K and V tiles use K3's row boxes");
  CUtensorMap tm_q, tm_k, tm_v, tm_g;
  cudaError_t err = make_rows_map(&tm_q, p.q, B, p.S, p.H, D, p.q_sb,
                                  p.q_ss, p.q_sh, DQ_BM);
  if (err == cudaSuccess)
    err = make_rows_map(&tm_k, p.k, B, p.S, p.KV, D, p.k_sb, p.k_ss, p.k_sh);
  if (err == cudaSuccess)
    err = make_rows_map(&tm_v, p.v, B, p.S, p.KV, D, p.v_sb, p.v_ss, p.v_sh);
  if (err == cudaSuccess)
    err = make_rows_map(&tm_g, p.g, B, p.S, p.H, D, p.g_sb, p.g_ss, p.g_sh,
                        DQ_BM);
  if (err != cudaSuccess) return err;
  constexpr int smem = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int items = (p.S + DQ_BM - 1) / DQ_BM * B * p.H;
  const int sms = sm_count(device);
  const int grid = items < sms ? items : sms;
  if (grid <= 0) return cudaErrorInvalidValue;
  flash_bwd_dq_wgmma_kernel<D>
      <<<grid, DQ_THREADS, smem, st>>>(tm_q, tm_k, tm_v, tm_g, p, B * p.H);
  return cudaGetLastError();
}

cudaError_t dispatch(const Params& p, int B, int D, int dtype, bool dq,
                     int device, cudaStream_t st) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (B == 0 || p.S == 0 || p.H == 0) return cudaSuccess;
  if (D == 128) return dq ? launch_dq<128>(p, B, dtype, device, st)
                          : launch_dkv<128>(p, B, dtype, device, st);
  if (D == 64) return dq ? launch_dq<64>(p, B, dtype, device, st)
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

// The dynamic shared memory of one bf16 K2 block at head dim D, in bytes.
extern "C" int flash_bwd_dq_smem_bytes(int D) {
  return D == 128 ? dq_smem_bytes<128>() : dq_smem_bytes<64>();
}
