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
// key tile. In f32 K1 and K4 share one kernel under a template flag
// (kBlock) whose epilogues differ; in bf16 each has its own (below).
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
// What the designs do about that bound. Both products run on the tensor
// cores, tiles past the diagonal are skipped (half the causal work), and
// the blocks with the most work launch first. K1 is built for Hopper's
// full rate: wgmma with the sums in registers, fed by TMA through a ring
// of swizzled stages on mbarriers by a producer warp, with two consumer
// warpgroups of 64 q rows each (see its section below). K4 keeps the first
// design: 64 q rows in four warps on mma.sync m16n8k16 with ldmatrix
// fetches, 64-key K/V tiles through a two-stage cp.async pipeline; its
// move onto K1's body is left to later work. The float32 path (tests, off
// the main path) uses plain FMA in a warp-per-row kernel.

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
// K4: bf16 mma.sync kernel
// ---------------------------------------------------------------------------

constexpr int BM = 64;      // q rows per block, 16 per warp
constexpr int BN = 64;      // keys per K/V tile
constexpr int NTHREADS = 128;

// Fragment layouts: see tile_mma.cuh.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_block_fwd_bf16_kernel(Params p) {
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
  // the accumulator unnormalized in f32, m back in natural-log units (the
  // loop keeps it in log2 units), l to match it
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
}

// ---------------------------------------------------------------------------
// K1: bf16 wgmma kernel, warp-specialised and persistent
// ---------------------------------------------------------------------------
//
// One block per SM walks the work items, (128 q rows, batch and head),
// heaviest causal rows first. Warpgroup 0 is the producer: one thread loads
// each item's Q and streams its K and V tiles of 128 keys through a
// three-stage ring that runs on across items, all by TMA from 4D tensor maps
// over [B, S, heads, D] (the wrapper's strides; rows past S are
// zero-filled). Q, and K and V of each stage, have their own full and
// empty mbarriers, so the next item's Q and first tiles load while the
// consumers finish the current one. Warpgroups 1 and 2 are the consumers,
// 64 q rows each. For each key tile a consumer runs S = Q K^T as wgmma
// m64n128k16 with both operands K-major in shared memory, the online
// softmax on the score fragments in its registers (max in log2 units,
// masked only in a tile that reaches past the diagonal or past S), rounds
// p to bf16 in registers and runs O += P V as wgmma m64nDk16 with P as the
// register operand and V MN-major (the transpose bit). The consumers take
// turns on the tensor cores (named barriers): in its turn a consumer runs
// P V of its previous tile and issues S of the next, then hands the turn
// over and runs that tile's softmax while the other one's products run.
// Tiles past the diagonal are never loaded. Shared memory: Q [128][D] and
// three stages of K, V [128][D], as D / 64 boxes of [128][64] with the
// 128-byte swizzle (225 KB at D 128). What is left of the bound: each
// consumer waits for its P V before it issues its next S (the registers
// of S, O and P together do not fit beside each other), and the softmax's
// exponentials, one per score on the special-function units, take about
// half as long as the two products.

constexpr int FA_BM = 128;  // q rows per work item
constexpr int FA_BN = 128;  // keys per K/V tile
constexpr int FA_THREADS = 384;
constexpr int FA_BOX = FA_BN * 128;  // bytes of one [128][64] box
constexpr int FA_STAGES = 3;         // of the K/V ring

template <int D>
constexpr int fa_smem_bytes() {  // Q, the K/V stages, the barriers
  return 1024 + (1 + 2 * FA_STAGES) * (D / 64) * FA_BOX +
         (2 + 4 * FA_STAGES) * 8;
}

// Work item i of a grid of n_qb q blocks x bh (batch, head) pairs: the
// heaviest q blocks first.
__device__ __forceinline__ void fa_item(int i, int n_qb, int bh_count,
                                        int& qb, int& bh) {
  qb = n_qb - 1 - i / bh_count;
  bh = i % bh_count;
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           Params p, int bh_count) {
  constexpr int TILE_BYTES = (D / 64) * FA_BOX;  // Q, or one K or V tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);
  unsigned char* sK = sQ + TILE_BYTES;              // [FA_STAGES]
  unsigned char* sV = sK + FA_STAGES * TILE_BYTES;  // [FA_STAGES]
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sV + FA_STAGES * TILE_BYTES);
  uint64_t* empty_q = full_q + 1;
  uint64_t* full_k = full_q + 2;
  uint64_t* full_v = full_k + FA_STAGES;
  uint64_t* empty_k = full_v + FA_STAGES;
  uint64_t* empty_v = empty_k + FA_STAGES;

  const int n_qb = (p.S + FA_BM - 1) / FA_BM;
  const int n_items = n_qb * bh_count;
  const int all_tiles = (p.S + FA_BN - 1) / FA_BN;
  // the key tiles of q block qb
  auto tiles_of = [&](int qb) {
    return p.causal ? min(all_tiles, (qb * FA_BM + FA_BM + FA_BN - 1) / FA_BN)
                    : all_tiles;
  };

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, 2);  // one thread of each consumer
    for (int s = 0; s < FA_STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 2);
      mbar_init(&empty_v[s], 2);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    setmaxnreg_dec<40>();
    if (threadIdx.x != 0) return;
    int it = 0;  // key tiles loaded so far, across items
    for (int i = blockIdx.x, j = 0; i < n_items; i += gridDim.x, ++j) {
      int qb, bh;
      fa_item(i, n_qb, bh_count, qb, bh);
      const int b = bh / p.H, h = bh % p.H, kvh = h / (p.H / p.KV);
      mbar_wait(empty_q, (j & 1) ^ 1);
      mbar_arrive_expect_tx(full_q, TILE_BYTES);
#pragma unroll
      for (int d = 0; d < D / 64; ++d)
        tma_load_4d(sQ + d * FA_BOX, &tm_q, full_q, d * 64, h, qb * FA_BM, b);
      const int n_tiles = tiles_of(qb);
      for (int t = 0; t < n_tiles; ++t, ++it) {
        const int st = it % FA_STAGES;
        const uint32_t free_phase = ((it / FA_STAGES) & 1) ^ 1;
        mbar_wait(&empty_k[st], free_phase);
        mbar_arrive_expect_tx(&full_k[st], TILE_BYTES);
#pragma unroll
        for (int d = 0; d < D / 64; ++d)
          tma_load_4d(sK + st * TILE_BYTES + d * FA_BOX, &tm_k, &full_k[st],
                      d * 64, kvh, t * FA_BN, b);
        mbar_wait(&empty_v[st], free_phase);
        mbar_arrive_expect_tx(&full_v[st], TILE_BYTES);
#pragma unroll
        for (int d = 0; d < D / 64; ++d)
          tma_load_4d(sV + st * TILE_BYTES + d * FA_BOX, &tm_v, &full_v[st],
                      d * 64, kvh, t * FA_BN, b);
      }
    }
  } else {  // a consumer warpgroup: 64 q rows of each item
    setmaxnreg_inc<232>();
    const int c = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t4 = lane & 3;
    const float scale_log2 = p.scale * kLog2e;
    const unsigned char* sQc = sQ + c * 64 * 128;  // rows c*64.. of each box
    float s[FA_BN / 2];          // scores, then p, of 64 rows x 128 keys
    uint32_t pa[FA_BN / 16][4];  // p in bf16: the A operand of P V
    float o[D / 2];
#pragma unroll
    for (int e = 0; e < FA_BN / 2; ++e) s[e] = 0.f;
    // The two consumers take turns on the tensor cores (named barriers
    // 1 + c): one issues its products while the other runs its softmax.
    // Consumer 1 lets consumer 0 go first.
    if (c == 1) named_bar_arrive(1, 256);
    auto my_turn = [&] { named_bar_sync(1 + c, 256); };
    auto their_turn = [&] { named_bar_arrive(2 - c, 256); };

    // O += P V of key tile `it`: V [128 keys][D] is B, MN-major
    auto pv = [&](int it) {
      const int st = it % FA_STAGES;
      mbar_wait(&full_v[st], (it / FA_STAGES) & 1);
      fence_operand(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < FA_BN / 16; ++kk) {
        const uint64_t dv =
            desc_mn_major(sV + st * TILE_BYTES + kk * 16 * 128, FA_BOX);
        if constexpr (D == 128)
          wgmma_m64n128k16_rs<1>(o, pa[kk], dv, 1);
        else
          wgmma_m64n64k16_rs<1>(o, pa[kk], dv, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(o);
      if (tid == 0) mbar_arrive(&empty_v[st]);
    };

    int it = 0;  // key tiles consumed so far, across items
    for (int i = blockIdx.x, j = 0; i < n_items; i += gridDim.x, ++j) {
      int qb, bh;
      fa_item(i, n_qb, bh_count, qb, bh);
      const int b = bh / p.H, h = bh % p.H;
      const int first_row = qb * FA_BM + c * 64 + warp * 16;  // this warp's
      const int row_a = first_row + lane / 4, row_b = row_a + 8;
      const int n_tiles = tiles_of(qb);
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
      float m_run[2] = {-INFINITY, -INFINITY};  // running max, log2 units
      float l_run[2] = {0.f, 0.f};  // this thread's partial row sums
      mbar_wait(full_q, j & 1);

      for (int t = 0; t < n_tiles; ++t, ++it) {
        const int st = it % FA_STAGES;
        const uint32_t full_phase = (it / FA_STAGES) & 1;
        // my turn: P V of the previous tile, then S = Q K^T of this one
        my_turn();
        if (t > 0) pv(it - 1);
        mbar_wait(&full_k[st], full_phase);
        fence_operand(s);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int off = (kk / 4) * FA_BOX + (kk % 4) * 32;
          wgmma_m64n128k16_ss<0>(s, desc_k_major(sQc + off),
                                 desc_k_major(sK + st * TILE_BYTES + off),
                                 kk > 0);
        }
        wgmma_commit();
        their_turn();
        wgmma_wait<0>();
        fence_operand(s);
        if (tid == 0) {
          mbar_arrive(&empty_k[st]);
          if (t == n_tiles - 1) mbar_arrive(empty_q);  // Q read for good
        }

        // scale in f32, mask, online softmax
        const int k0 = t * FA_BN;
        const bool masked =
            (k0 + FA_BN > p.S) || (p.causal && k0 + FA_BN - 1 > first_row);
        float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
        for (int jj = 0; jj < FA_BN / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[4 * jj + e] * scale_log2;
            if (masked) {
              const int key = k0 + jj * 8 + t4 * 2 + (e & 1);
              const int row = (e < 2) ? row_a : row_b;
              if (key >= p.S || (p.causal && key > row)) x = -INFINITY;
            }
            s[4 * jj + e] = x;
          }
          mx[0] = fmaxf(mx[0], fmaxf(s[4 * jj], s[4 * jj + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[4 * jj + 2], s[4 * jj + 3]));
        }
        float corr[2], mu[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          mu[r] = (mx[r] == -INFINITY) ? 0.f : mx[r];  // no key yet
          corr[r] = fast_exp2(m_run[r] - mu[r]);
          m_run[r] = mx[r];
        }
        float row_sum[2] = {0.f, 0.f};
#pragma unroll
        for (int jj = 0; jj < FA_BN / 8; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[4 * jj + e] = fast_exp2(s[4 * jj + e] - mu[e / 2]);
          row_sum[0] += s[4 * jj] + s[4 * jj + 1];
          row_sum[1] += s[4 * jj + 2] + s[4 * jj + 3];
          // accumulator layout = register A layout: key groups 2kk and
          // 2kk + 1 form k16 step kk
          pa[jj / 2][(jj & 1) * 2] = pack_bf16(s[4 * jj], s[4 * jj + 1]);
          pa[jj / 2][(jj & 1) * 2 + 1] =
              pack_bf16(s[4 * jj + 2], s[4 * jj + 3]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
          l_run[r] = l_run[r] * corr[r] + row_sum[r];
#pragma unroll
        for (int jj = 0; jj < D / 8; ++jj) {  // P V of the last tile is in
          o[4 * jj] *= corr[0];
          o[4 * jj + 1] *= corr[0];
          o[4 * jj + 2] *= corr[1];
          o[4 * jj + 3] *= corr[1];
        }
      }
      my_turn();  // P V of the item's last tile
      pv(it - 1);
      their_turn();

#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
      }
      __nv_bfloat16* og =
          static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int col = jj * 8 + t4 * 2;
        if (row_a < p.S)
          *reinterpret_cast<uint32_t*>(og + row_a * p.o_ss + col) =
              pack_bf16(o[4 * jj] / l_run[0], o[4 * jj + 1] / l_run[0]);
        if (row_b < p.S)
          *reinterpret_cast<uint32_t*>(og + row_b * p.o_ss + col) =
              pack_bf16(o[4 * jj + 2] / l_run[1], o[4 * jj + 3] / l_run[1]);
      }
      if (t4 == 0) {
        float* lse = p.lse + static_cast<long long>(bh) * p.S;
        if (row_a < p.S) lse[row_a] = m_run[0] * kLn2 + logf(l_run[0]);
        if (row_b < p.S) lse[row_b] = m_run[1] * kLn2 + logf(l_run[1]);
      }
    }
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

// The 4D tensor map of a [B, S, heads, D] bf16 tensor read through its
// element strides: boxes of 64 columns of one head and 128 rows.
template <int D>
cudaError_t make_rows_map(CUtensorMap* map, const void* base, int B, int S,
                          int heads, long long sb, long long ss,
                          long long sh) {
  const cuuint64_t dims[4] = {D, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, FA_BN, 1};
  return make_map_bf16(map, base, 4, dims, strides, box);
}

// K1 in bf16: the tensor maps (encoding reads no device memory), then one
// persistent block per SM, at most one per work item.
template <int D>
cudaError_t launch_k1_bf16(const Params& p, int B, int device,
                           cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err =
      make_rows_map<D>(&tm_q, p.q, B, p.S, p.H, p.q_sb, p.q_ss, p.q_sh);
  if (err == cudaSuccess)
    err = make_rows_map<D>(&tm_k, p.k, B, p.S, p.KV, p.k_sb, p.k_ss, p.k_sh);
  if (err == cudaSuccess)
    err = make_rows_map<D>(&tm_v, p.v, B, p.S, p.KV, p.v_sb, p.v_ss, p.v_sh);
  if (err != cudaSuccess) return err;
  constexpr int smem = fa_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int items = (p.S + FA_BM - 1) / FA_BM * B * p.H;
  const int sms = sm_count(device);
  const int grid = items < sms ? items : sms;
  if (grid <= 0) return cudaErrorInvalidValue;
  flash_fwd_wgmma_kernel<D>
      <<<grid, FA_THREADS, smem, stream>>>(tm_q, tm_k, tm_v, p, B * p.H);
  return cudaGetLastError();
}

// K4 in bf16.
template <int D>
cudaError_t launch_k4_bf16(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = (BM + 4 * BN) * (D + PAD) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_block_fwd_bf16_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + BM - 1) / BM, B * p.H);
  flash_block_fwd_bf16_kernel<D><<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D, bool kBlock>
cudaError_t launch_bf16(const Params& p, int B, int device,
                        cudaStream_t stream) {
  if (kBlock) return launch_k4_bf16<D>(p, B, stream);
  return launch_k1_bf16<D>(p, B, device, stream);
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
  if (B == 0 || p.S == 0 || p.H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && D == 128)
    err = launch_bf16<128, kBlock>(p, B, device, st);
  else if (dtype == 1 && D == 64)
    err = launch_bf16<64, kBlock>(p, B, device, st);
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

// The dynamic shared memory of one bf16 K1 block at head dim D, in bytes.
extern "C" int flash_fwd_smem_bytes(int D) {
  return D == 128 ? fa_smem_bytes<128>() : fa_smem_bytes<64>();
}
