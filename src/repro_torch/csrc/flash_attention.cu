// Flash attention forward on Hopper (sm_90a): causal or full attention
// over (B, Tq, H, dqk) queries, (B, Tk, Kv, dqk) keys and (B, Tk, Kv, dv)
// values into a (B, Tq, H, dv) output, with GQA, an optional softcap and
// sliding window, and an f32 online softmax.  The head dims are template
// parameters: dqk = dv in {64, 128, 256} for the dense models, and
// (dqk, dv) = (192, 128) for the expanded prefill of multi-head latent
// attention (MLA: 128 "nope" plus 64 rotary columns against 128 of V).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_fwd, pallas_call at line 138).  The TPU kernel runs a
// (B*H, nq, nk) grid whose innermost kv axis is sequential, carrying the
// softmax state in VMEM scratch from one grid step to the next, and needs
// GQA expanded upstream (a jnp.repeat copy of K/V).  Here one block owns
// one (batch, head, q tile) and loops over the kv tiles itself, so the
// softmax state stays in registers; query head h reads kv head
// h / (H / Kv) in place, so no repeated copy of K/V is made.
//
// Two routes, chosen by the input type alone, both on the tensor cores:
//
// * bf16 / f16: the tensor-core kernel (`flash_wgmma_kernel`).  A block
//   is NC consumer warpgroups of 64 query rows each (NC = 2 for dv 64 and
//   128, 1 for dv 256, whose output alone takes 128 f32 registers a
//   thread) and one producer warpgroup, which gives its registers to the
//   consumers (setmaxnreg 24 / 240) and whose first thread issues every
//   load.  It loads the Q tiles once and streams 64-key K and V tiles
//   through a two-stage ring in shared memory with TMA
//   (cp.async.bulk.tensor, 128-byte swizzle; K and V each complete on an
//   mbarrier of their own), and reloads a stage when every consumer
//   thread has arrived on its "empty" barrier.
//   - S = Q.K^T is wgmma m64n64k16 (bf16/f16 in, f32 accumulators), dqk/16
//     k-steps, both operands read from shared memory through descriptors
//     (Q and K arrive as dqk/64 column chunks, V as dv/64).
//   - O += P.V is wgmma m64n64k16 per 64 columns of V: P comes from
//     registers (the S accumulator exponentiated, rounded to the input
//     type and packed as the A fragment), V is read from shared memory
//     as an MN-major ("transposed") B operand, so V is never copied
//     transposed.
//   - A tile's S is issued together with the previous tile's P.V, so the
//     softmax of one overlaps the other's product.
//   - The softmax folds scale*log2(e) into the exponent's fma and uses
//     exp2 (with a softcap, tanh on the f32 scores first); row max and
//     sum are reduced over the 4 threads of a quad that own a row.  The
//     causal, window and ragged-edge masks run only on a tile that
//     crosses them.  The row sum adds up the rounded P, so the weights
//     the product uses sum to one.
//   - Tiles above the diagonal or outside the window are never loaded.
//     With two warpgroups a block takes q tiles i and n - 1 - i of one
//     head, so every block carries the same causal work; with one, the
//     heaviest tiles run first.
//   - No split over keys and no atomics: two calls give the same bytes.
//   - The branches around wgmma must be provably warp-uniform (the
//     warpgroup index goes through a shuffle), or ptxas serializes every
//     wgmma; and each softmax step runs under a uniform branch of its
//     own, or the compiler evaluates tanh and the mask for every tile.
// * f32 ("tf32x3"): `flash_tf32_kernel`, on the tensor cores in 3xTF32
//   (mma.sync m16n8k8; tf32.h).  wgmma takes TF32 only with both operands
//   K-major in shared memory, which P.V's V is not, and one TF32 product
//   would not hold the f32 tolerance; three do: each f32 operand is split
//   in registers into its TF32 high part and the TF32 cut of the rest, and
//   lo.hi + hi.lo + hi.hi are summed in f32.
//   - A block owns 64 query rows of one (batch, head), the heaviest causal
//     tiles first, 16 rows a warp.  Q stays in shared memory; K and V tiles
//     stream through a two-stage cp.async ring (16-byte copies where the
//     bases and strides allow, else 4-byte).  Two groups of 4 warps walk
//     32 keys each of every 64-key tile, each with a softmax state of its
//     own, folded at the end: the last q tiles' walk, which bounds the
//     kernel at the training and prefill shapes (every block is resident
//     at once), takes half as long.  At dh 256, 32-key tiles.
//     Row strides of head dim + 4 floats keep every fragment read on 32
//     banks.
//   - S = Q.K^T: both operands by ldmatrix (rows along the head dim), split
//     at fragment load.  The online softmax is the tensor-core route's, in
//     f32 registers: a lane owns rows g and g + 8, the row max and sum go
//     over the quad by two shuffles, the softcap and the masks act on the
//     tiles that cross them, and tiles no row of a warp sees are skipped.
//   - O += P.V without a shuffle or a trip through shared memory: the m16n8
//     accumulator holds keys 2t, 2t + 1 of its 8, and the A fragment wants
//     k positions t, t + 4; as the product sums over keys, k position t
//     stands for key 2t and t + 4 for key 2t + 1, V's B fragment is read in
//     that order (rows 2t and 2t + 1), and the exponentiated accumulators
//     are P's A fragments as they are.
//   The layout is free: any base and strides with the head dim contiguous.
//
// TMA's rules bind the bf16/f16 route: every base address 16-byte
// aligned, every batch/token/head stride a multiple of 16 bytes, the head
// dim contiguous.  The wrapper raises on anything else.
//
// Arithmetic (both routes): q.k in f32, times `scale`, then
// softcap * tanh(s / softcap), then the mask; p = exp(s - m) in f32; the
// output is acc / max(l, 1e-30), rounded to the input type.  The
// bf16/f16 route rounds p to the input type before p.v.
//
// What bounds it: 2 * Tq * Tk * (dqk + dv) * H operations (about half when
// causal) against reading q, k, v and writing o once: at the prefill's
// shapes the tensor cores' rate, for f32 the TF32 peak (495 TFLOP/s on an
// H100 SXM; the f32 route runs each product three times, so its as-run
// bound is three times that).  At the qwen2.5-3b prefill's shape
// (B=1, T=1024, H=16, dh=128) the kernel is held back by the latency of
// one warpgroup's chain of tiles: the block with q tiles 0 and 15 runs 16
// key tiles on one warpgroup, most of them with its partner idle, about
// 0.85 us a tile (PERF.md, PR 15).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.h"
#include "per_device.h"

namespace {

constexpr float kMask = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, Tq) f32 log-sum-exp of each row's scores; null: off
  int64_t q_sb, q_st, q_sh;  // element strides: batch, token, head
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_st, o_sh;
  int B, Tq, Tk, H, Kv;
  float scale;
  float softcap;  // <= 0: off
  int causal;
  int window;  // <= 0: none
  int vec;     // f32 route: q, k, v bases and strides 16-byte aligned (cp.async 16)
};

// The kv range [begin, end) a q tile of rows [q0, q0 + rows) can see.
__device__ __forceinline__ void kv_range(const Args& a, int q0, int rows,
                                         int* begin, int* end) {
  *end = a.causal ? min(a.Tk, q0 + rows) : a.Tk;
  *begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
}

// -- the f32 route: 3xTF32 on mma.sync -----------------------------------------

constexpr int kF32BlockQ = 64;  // query rows a block: 4 warps of 16

// Shared memory of an f32 block, in floats: the Q tile (64 rows), then
// STAGES stages of a K tile and a V tile (KSPLIT * BK keys each), cp.async's
// ring.  Every row stride is its head dim + 4 (= 4 mod 32): the eight rows
// of an ldmatrix (Q and K) and the key-order reads of V (rows 2t and 2t +
// 1, columns g) fall on distinct banks.  With KSPLIT 2 the ring then holds
// the second group's o, m and l for the combine.
template <int DQK, int DV, int BK, int KSPLIT, int STAGES>
struct F32Layout {
  static constexpr int QS = DQK + 4, KS = DQK + 4, VS = DV + 4;
  static constexpr int TK = KSPLIT * BK;     // keys a stage holds
  static constexpr int K = kF32BlockQ * QS;  // the first stage
  static constexpr int STAGE = TK * (KS + VS);
  static constexpr int BYTES = (K + STAGES * STAGE) * 4;
  static_assert(KSPLIT == 1 || 4 * 32 * (DV / 2 + 4) <= STAGES * STAGE,
                "the ring holds a group's o, m and l");
};

// A block owns one (batch, head, 64-row q tile), the heaviest causal tiles
// first, and KSPLIT groups of 4 warps: warp w of group c takes rows 16 w ..
// + 16 and, of each stage's KSPLIT * BK keys, keys c * BK .. + BK, with a
// softmax state of its own.  With two groups a row's keys are walked in
// two halves at once (the last q tiles' walk, the kernel's longest, takes
// half as long), and the second group's state is folded into the first's
// at the end, always in that order.
template <int DQK, int DV, int BK, int KSPLIT, int STAGES>
__global__ void __launch_bounds__(128 * KSPLIT)
    flash_tf32_kernel(const Args a) {
  using L = F32Layout<DQK, DV, BK, KSPLIT, STAGES>;
  constexpr int NT = 128 * KSPLIT;
  constexpr int NK = BK / 8;  // 8-key groups of a warp's keys
  constexpr int NV = DV / 8;  // 8-column groups of the output
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp % 4, grp = warp / 4;
  const int BH = a.B * a.H;
  const int n_qt = (a.Tq + kF32BlockQ - 1) / kF32BlockQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / BH;  // heaviest first
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / a.H, h = bh % a.H;
  const int kvh = h / (a.H / a.Kv);
  const int q0 = qt * kF32BlockQ;
  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  int k_begin, k_end;
  kv_range(a, q0, kF32BlockQ, &k_begin, &k_end);
  const int t_begin = k_begin / L::TK;
  const int n_tiles = max(0, (k_end + L::TK - 1) / L::TK - t_begin);
  auto load_kv = [&](int it) {
    float* st = smem + L::K + (it % STAGES) * L::STAGE;
    const int k0 = (t_begin + it) * L::TK;
    load_tile_async<DQK, L::TK, NT>(st, L::KS, k, a.k_st, k0, a.Tk, a.vec);
    load_tile_async<DV, L::TK, NT>(st + L::TK * L::KS, L::VS, v, a.v_st, k0, a.Tk,
                                   a.vec);
  };
  // Q lands with the first K/V tile's group
  load_tile_async<DQK, kF32BlockQ, NT>(smem, L::QS, q, a.q_st, q0, a.Tq, a.vec);
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_kv(s);
    cp_async_commit();
  }

  // warp rw owns query rows [qa, qa + 16); in the m16n8 accumulator
  // layout a lane holds rows row0 and row1, columns 8 j + col + {0, 1} of
  // each 8-column group j
  const int qa = q0 + 16 * rw;
  const int qb = qa + 15;
  const int row0 = qa + lane / 4;
  const int row1 = row0 + 8;
  const int col = 2 * (lane % 4);
  const bool capped = a.softcap > 0.f;
  // scores to the log2 domain, as the tensor-core route does
  const float sl = a.scale * kLog2e;
  const bool prescaled = capped || !(sl > 0.f);
  const float mul = prescaled ? 1.f : sl;
  const float cap_in = a.scale / a.softcap;
  const float cap_out = a.softcap * kLog2e;

  float o[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 domain
  float l0 = 0.f, l1 = 0.f;              // this lane's share of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    if (it + STAGES - 1 < n_tiles) load_kv(it + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // tile it (and Q) landed
    __syncthreads();
    const int k0 = (t_begin + it) * L::TK + grp * BK;  // this group's keys
    // keys no row of this warp sees are skipped (warp-uniform)
    const bool dead = (a.causal && k0 > qb) ||
                      (a.window > 0 && qa - (k0 + BK - 1) >= a.window);
    if (!dead) {
      const float* sK = smem + L::K + (it % STAGES) * L::STAGE + grp * BK * L::KS;
      const float* sV = smem + L::K + (it % STAGES) * L::STAGE + L::TK * L::KS +
                        grp * BK * L::VS;
      float d[1][NK][4];
      zero(d);
      mma3<1, NK, DQK, (DV > 128 ? 1 : 2)>(d, KRows{smem + 16 * rw * L::QS, L::QS},
                                            KRows{sK, L::KS});
      // softcap, the mask (only on keys that cross an edge), the new row
      // max and exp2(s * mul - max), each step under a uniform branch
      const bool edge = k0 + BK > a.Tk || (a.causal && k0 + BK - 1 > qa) ||
                        (a.window > 0 && qb - k0 >= a.window);
      if (capped) {
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[0][j][e] = cap_out * tanhf(d[0][j][e] * cap_in);
      } else if (prescaled) {
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) d[0][j][e] *= sl;
      }
      if (edge) {
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = (e & 2) ? row1 : row0;
            const int key = k0 + 8 * j + col + (e & 1);
            bool live = key < a.Tk;
            if (a.causal) live = live && row >= key;
            if (a.window > 0) live = live && row - key < a.window;
            if (!live) d[0][j][e] = -INFINITY;
          }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        mx0 = fmaxf(mx0, fmaxf(d[0][j][0], d[0][j][1]));
        mx1 = fmaxf(mx1, fmaxf(d[0][j][2], d[0][j][3]));
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
      }
      // a row that has seen no key keeps max -inf: exponentiate against 0
      const float mn0 = fmaxf(m0, mx0 * mul);
      const float mn1 = fmaxf(m1, mx1 * mul);
      const float z0 = mn0 == -INFINITY ? 0.f : mn0;
      const float z1 = mn1 == -INFINITY ? 0.f : mn1;
      const float c0 = ex2(m0 - z0), c1 = ex2(m1 - z1);
      m0 = mn0;
      m1 = mn1;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d[0][j][e] = ex2(fmaf(d[0][j][e], mul, (e & 2) ? -z1 : -z0));
        s0 += d[0][j][0] + d[0][j][1];
        s1 += d[0][j][2] + d[0][j][3];
      }
      l0 = l0 * c0 + s0;
      l1 = l1 * c1 + s1;
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[j][e] *= (e & 2) ? c1 : c0;
      // O += P.V: P's accumulators are the A fragments in key order
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t pa[4];
        acc_as_a(d[0][kk], pa);
        mma3_pairs<NV>(o, pa, sV + 8 * kk * L::VS, L::VS);
      }
    }
    __syncthreads();  // the stage is read before it is loaded again
  }

  if (KSPLIT == 2) {
    // the second group's o, m and l through the ring (its loads are all
    // consumed), folded into the first group's
    float4* x = reinterpret_cast<float4*>(smem + L::K) + rw * (NV + 1) * 32 + lane;
    if (grp == 1) {
#pragma unroll
      for (int j = 0; j < NV; ++j) x[32 * j] = make_float4(o[j][0], o[j][1], o[j][2], o[j][3]);
      x[32 * NV] = make_float4(m0, m1, l0, l1);
    }
    __syncthreads();
    if (grp == 1) return;
    const float4 ml = x[32 * NV];
    const float mn0 = fmaxf(m0, ml.x), mn1 = fmaxf(m1, ml.y);
    const float z0 = mn0 == -INFINITY ? 0.f : mn0;
    const float z1 = mn1 == -INFINITY ? 0.f : mn1;
    const float ca0 = ex2(m0 - z0), ca1 = ex2(m1 - z1);
    const float cb0 = ex2(ml.x - z0), cb1 = ex2(ml.y - z1);
    m0 = mn0;
    m1 = mn1;
    l0 = l0 * ca0 + ml.z * cb0;
    l1 = l1 * ca1 + ml.w * cb1;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const float4 ob = x[32 * j];
      o[j][0] = o[j][0] * ca0 + ob.x * cb0;
      o[j][1] = o[j][1] * ca0 + ob.y * cb0;
      o[j][2] = o[j][2] * ca1 + ob.z * cb1;
      o[j][3] = o[j][3] * ca1 + ob.w * cb1;
    }
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  // lse = (m + log2 l) ln 2; a row that saw no key gets +inf
  if (a.lse != nullptr && col == 0) {
    float* lrow = a.lse + (static_cast<int64_t>(b) * a.H + h) * a.Tq;
    constexpr float kLn2 = 0.6931471805599453f;
    if (row0 < a.Tq)
      lrow[row0] = m0 == -INFINITY || !(l0 > 0.f) ? INFINITY : (m0 + log2f(l0)) * kLn2;
    if (row1 < a.Tq)
      lrow[row1] = m1 == -INFINITY || !(l1 > 0.f) ? INFINITY : (m1 + log2f(l1)) * kLn2;
  }
  float* out = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = 8 * j + col;
    if (row0 < a.Tq)
      *reinterpret_cast<float2*>(out + row0 * a.o_st + c) =
          make_float2(o[j][0] * inv0, o[j][1] * inv0);
    if (row1 < a.Tq)
      *reinterpret_cast<float2*>(out + row1 * a.o_st + c) =
          make_float2(o[j][2] * inv1, o[j][3] * inv1);
  }
}

// -- the bf16/f16 route: wgmma fed by TMA --------------------------------------

constexpr int kBlockK = 64;  // keys per kv tile
constexpr int kStages = 2;   // K/V ring depth

// Shared-memory layout of a tensor-core block: the Q tile, the K and V
// rings, then the mbarriers (Q loaded; per stage K loaded, V loaded, and
// "empty": released by every consumer thread).  Each tile is stored as
// DQK/64 (Q, K) or DV/64 (V) column chunks of (rows x 128 bytes), the
// layout TMA's 128-byte swizzle writes and wgmma's descriptors read.
template <int DQK, int DV, int NC>
struct TcLayout {
  static constexpr int BQ = 64 * NC;  // query rows: 64 per consumer warpgroup
  static constexpr int THREADS = (NC + 1) * 128;  // + the producer warpgroup
  static constexpr int K_BYTES = kBlockK * DQK * 2;  // one K tile
  static constexpr int V_BYTES = kBlockK * DV * 2;   // one V tile
  static constexpr int K_OFF = BQ * DQK * 2;
  static constexpr int V_OFF = K_OFF + kStages * K_BYTES;
  static constexpr int BAR_OFF = V_OFF + kStages * V_BYTES;
  // + slack to align the dynamic base to the 1024-byte swizzle atom
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 3 * kStages) + 1024;
};

template <typename T, int DQK, int DV, int NC>
__global__ void __launch_bounds__(TcLayout<DQK, DV, NC>::THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap kmap,
              const __grid_constant__ CUtensorMap vmap, const Args a) {
  using L = TcLayout<DQK, DV, NC>;
  constexpr int NQ = DQK / kChunk;  // 64-column chunks of q and k
  constexpr int ND = DV / kChunk;   // 64-column chunks of v and o
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = base + L::K_OFF;
  const uint32_t sV = base + L::V_OFF;
  const uint32_t q_full = base + L::BAR_OFF;
  const uint32_t k_full = q_full + 8;            // + 8 * stage
  const uint32_t v_full = k_full + 8 * kStages;  // + 8 * stage
  const uint32_t empty = v_full + 8 * kStages;   // + 8 * stage

  // Work items, each warpgroup a 64-row q tile of one (batch, head).  One
  // consumer warpgroup: the heaviest causal tiles first.  Two: tiles i and
  // n - 1 - i, so that every block carries the same causal work (n + 1 key
  // tiles); for odd n the middle tile's block leaves warpgroup 1 idle.
  const int BH = a.B * a.H;
  const int n64 = (a.Tq + 63) / 64;
  const int item = static_cast<int>(blockIdx.x);
  const int bh = item % BH;
  const int tile0 = NC == 1 ? n64 - 1 - item / BH : item / BH;
  const int tile1 = n64 - 1 - tile0;
  const bool two = NC == 2 && tile1 > tile0;  // warpgroup 1 has rows
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int kvh = h / (a.H / a.Kv);
  // the keys any row of the block sees
  int k_begin, k_end;
  kv_range(a, 64 * tile0, 64, &k_begin, &k_end);
  if (two) {
    int b1, e1;
    kv_range(a, 64 * tile1, 64, &b1, &e1);
    k_begin = min(k_begin, b1);
    k_end = max(k_end, e1);
  }
  const int t_begin = k_begin / kBlockK;
  const int n_tiles = max(0, (k_end + kBlockK - 1) / kBlockK - t_begin);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the last block-wide barrier: the roles part here

  const int wg = warpgroup();
  if (wg == NC) {
    // producer warpgroup: it hands its registers to the consumers, and one
    // thread issues every TMA load
    producer_regs<NC>();
    if (threadIdx.x == NC * 128) {
      mbar_expect_tx(q_full, (two ? 2 : 1) * 64 * DQK * 2);
      for (int c = 0; c < NQ; ++c) {
        tma_load(sQ + c * L::BQ * kRowBytes, &qmap, q_full, c * kChunk, h,
                 64 * tile0, b);
        if (two)
          tma_load(sQ + c * L::BQ * kRowBytes + 64 * kRowBytes, &qmap, q_full,
                   c * kChunk, h, 64 * tile1, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty + 8 * s, ((it / kStages) - 1) & 1);
        const int k0 = (t_begin + it) * kBlockK;
        mbar_expect_tx(k_full + 8 * s, L::K_BYTES);
        for (int c = 0; c < NQ; ++c)
          tma_load(sK + s * L::K_BYTES + c * kBlockK * kRowBytes, &kmap,
                   k_full + 8 * s, c * kChunk, kvh, k0, b);
        mbar_expect_tx(v_full + 8 * s, L::V_BYTES);
        for (int c = 0; c < ND; ++c)
          tma_load(sV + s * L::V_BYTES + c * kBlockK * kRowBytes, &vmap,
                   v_full + 8 * s, c * kChunk, kvh, k0, b);
      }
    }
    return;
  }

  // consumer warpgroup `wg` owns query rows [qa, qa + 64); in the wgmma
  // accumulator layout a thread holds rows row0 and row0 + 8, columns
  // 8 * j + col + {0, 1} of every 8-column group j
  consumer_regs<NC>();
  const bool rows = wg == 0 || two;  // warpgroup-uniform
  const int qa = 64 * (wg == 0 ? tile0 : tile1);
  const int qb = qa + 63;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int row0 = qa + 16 * warp + lane / 4;
  const int row1 = row0 + 8;
  const int col = 2 * (lane % 4);
  const bool capped = a.softcap > 0.f;
  // scores to the log2 domain: one multiply folded into the exponent's
  // fma, or a pass of their own (softcap * tanh, or a scale <= 0, under
  // which the row max is not the max of the raw scores)
  const float sl = a.scale * kLog2e;
  const bool prescaled = capped || !(sl > 0.f);
  const float mul = prescaled ? 1.f : sl;
  const float cap_in = a.scale / a.softcap;
  const float cap_out = a.softcap * kLog2e;
  const uint32_t q_wg = sQ + wg * 64 * kRowBytes;

  float o[ND][32];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[j][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 domain
  float l0 = 0.f, l1 = 0.f;  // this thread's share of the row sums
  float d[32];               // scores, then their exponentials
  uint32_t p[4][4];          // P of the last tile, packed

  // The block loads tiles [0, n_tiles); this warpgroup's rows see keys of
  // [live0, live1) (warpgroup-uniform).  The others it only releases.
  auto dead = [&](int it) {
    const int k0 = (t_begin + it) * kBlockK;
    return !rows || (a.causal && k0 > qb) ||
           (a.window > 0 && qa - (k0 + kBlockK - 1) >= a.window);
  };
  int live0 = 0, live1 = n_tiles;
  while (live0 < n_tiles && dead(live0)) ++live0;
  while (live1 > live0 && dead(live1 - 1)) --live1;
  auto wait_k = [&](int it) {
    mbar_wait(k_full + 8 * (it % kStages), (it / kStages) & 1);
  };
  auto wait_v = [&](int it) {
    mbar_wait(v_full + 8 * (it % kStages), (it / kStages) & 1);
  };
  auto release = [&](int it) { mbar_arrive(empty + 8 * (it % kStages)); };
  // S = Q.K^T for tile `it` into d
  auto issue_s = [&](int it) {
    const uint32_t ks = sK + (it % kStages) * L::K_BYTES;
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
      wgmma_ss<T>(d, kmajor_desc(q_wg, L::BQ, kk), kmajor_desc(ks, kBlockK, kk),
                  kk > 0);
    }
  };
  // O += P.V for tile `it`, V MN-major: 8-key groups 1024 bytes apart,
  // 64-column chunks kBlockK * 128 bytes apart
  auto issue_pv = [&](int it) {
    wait_v(it);
    const uint32_t vs = sV + (it % kStages) * L::V_BYTES;
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < ND; ++j)
        wgmma_rs<T>(o[j], p[kk], mnmajor_desc(vs, kk, j));
  };
  // softcap, the mask (only on a tile that crosses an edge), the new row
  // max, and exp2(s * mul - max) left in d; returns the correction
  // factors of the old sums and accumulators.  Each step is a loop under
  // a uniform branch, so that no tile pays for tanh or the mask unless
  // it needs them.
  auto softmax = [&](int it, float* c0, float* c1) {
    const int k0 = (t_begin + it) * kBlockK;
    const bool edge = k0 + kBlockK > a.Tk ||
                      (a.causal && k0 + kBlockK - 1 > qa) ||
                      (a.window > 0 && qb - k0 >= a.window);
    if (capped) {
#pragma unroll
      for (int i = 0; i < 32; ++i) d[i] = cap_out * tanhf(d[i] * cap_in);
    } else if (prescaled) {
#pragma unroll
      for (int i = 0; i < 32; ++i) d[i] *= sl;
    }
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int row = (i & 2) ? row1 : row0;
        const int key = k0 + 8 * (i / 4) + col + (i & 1);
        bool live = key < a.Tk;
        if (a.causal) live = live && row >= key;
        if (a.window > 0) live = live && row - key < a.window;
        if (!live) d[i] = -INFINITY;
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      mx0 = fmaxf(mx0, fmaxf(d[i], d[i + 1]));
      mx1 = fmaxf(mx1, fmaxf(d[i + 2], d[i + 3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    // a row that has seen no key keeps max -inf: exponentiate against 0
    const float mn0 = fmaxf(m0, mx0 * mul);
    const float mn1 = fmaxf(m1, mx1 * mul);
    const float z0 = mn0 == -INFINITY ? 0.f : mn0;
    const float z1 = mn1 == -INFINITY ? 0.f : mn1;
    *c0 = ex2(m0 - z0);
    *c1 = ex2(m1 - z1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = ex2(fmaf(d[i], mul, (i & 2) ? -z1 : -z0));
  };
  // rescale O and the sums, and pack P rounded to T as wgmma's A
  // fragments; the sums add up the rounded P, so the weights P.V uses sum
  // to one
  auto rescale_pack = [&](float c0, float c1) {
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[j][i] *= (i & 2) ? c1 : c0;
    float s0, s1;
    pack_a<T>(d, p, &s0, &s1);
    l0 = l0 * c0 + s0;
    l1 = l1 * c1 + s1;
  };

  mbar_wait(q_full, 0);
  // tiles no row of this warpgroup sees: both loads must land before the
  // stage is released (a barrier's phases are told apart by parity alone)
  for (int it = 0; it < live0; ++it) {
    wait_k(it);
    wait_v(it);
    release(it);
  }
  if (live0 < live1) {
    float c0, c1;
    wait_k(live0);
    wg_fence();
    issue_s(live0);
    wg_commit();
    wg_wait<0>();
    softmax(live0, &c0, &c1);
    rescale_pack(c0, c1);
    // steady state: tile it's S and tile it-1's P.V in flight together,
    // the softmax of tile it overlapping the P.V
    for (int it = live0 + 1; it < live1; ++it) {
      wait_k(it);
      wg_fence();
      issue_s(it);
      wg_commit();
      issue_pv(it - 1);
      wg_commit();
      wg_wait<1>();  // S is in; P.V may still run
      softmax(it, &c0, &c1);
      wg_wait<0>();
      release(it - 1);
      rescale_pack(c0, c1);
    }
    wg_fence();
    issue_pv(live1 - 1);
    wg_commit();
    wg_wait<0>();
    release(live1 - 1);
  }
  for (int it = live1; it < n_tiles; ++it) {
    wait_k(it);
    wait_v(it);
    release(it);
  }
  if (!rows) return;

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  // lse = (m + log2 l) ln 2, m the running max in the log2 domain; a row
  // that saw no key gets +inf (its weights are 0)
  if (a.lse != nullptr && lane % 4 == 0) {
    float* lrow = a.lse + (static_cast<int64_t>(b) * a.H + h) * a.Tq;
    constexpr float kLn2 = 0.6931471805599453f;
    if (row0 < a.Tq)
      lrow[row0] = m0 == -INFINITY || !(l0 > 0.f) ? INFINITY : (m0 + log2f(l0)) * kLn2;
    if (row1 < a.Tq)
      lrow[row1] = m1 == -INFINITY || !(l1 > 0.f) ? INFINITY : (m1 + log2f(l1)) * kLn2;
  }
  T* out = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const int c = kChunk * j + 8 * g + col;
      float r0, r1;
      if (row0 < a.Tq)
        *reinterpret_cast<uint32_t*>(out + row0 * a.o_st + c) =
            pack2<T>(o[j][4 * g] * inv0, o[j][4 * g + 1] * inv0, &r0, &r1);
      if (row1 < a.Tq)
        *reinterpret_cast<uint32_t*>(out + row1 * a.o_st + c) =
            pack2<T>(o[j][4 * g + 2] * inv1, o[j][4 * g + 3] * inv1, &r0, &r1);
    }
  }
}

// -- host side -------------------------------------------------------------------

template <int DQK, int DV, int BK, int KSPLIT, int STAGES>
cudaError_t f32_launch(const Args& a, int device, cudaStream_t stream) {
  using L = F32Layout<DQK, DV, BK, KSPLIT, STAGES>;
  static_assert(L::BYTES <= 232448, "an f32 block must fit one SM");
  auto kernel = flash_tf32_kernel<DQK, DV, BK, KSPLIT, STAGES>;
  static PerDevice configured;  // the attribute, per kernel and device
  const cudaError_t err = configured.once(device, [&] {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  });
  if (err != cudaSuccess) return err;
  const int n_qt = (a.Tq + kF32BlockQ - 1) / kF32BlockQ;
  kernel<<<n_qt * a.B * a.H, 128 * KSPLIT, L::BYTES, stream>>>(a);
  return cudaGetLastError();
}

// The built head dims (dqk, dv) and tiles of the f32 route: 64 query rows
// a block, two groups of 4 warps, two stages; at (64, 64), (128, 128) and
// (192, 128) each group walks 32 keys of a 64-key K/V tile (85, 165 and
// 213 KB of shared memory), at (256, 256) 16 of a 32-key tile (195 KB; the
// output's 128 f32 registers a thread leave no room for more scores).
// block_k, the keys a stage holds, is the wrapper's plan's.
cudaError_t f32_dispatch(int dqk, int dv, int block_q, int block_k, const Args& a,
                         int device, cudaStream_t stream) {
  if (block_q != kF32BlockQ || block_k != (dqk == 256 ? 32 : 64))
    return cudaErrorInvalidValue;
  if (dqk == 192 && dv == 128) return f32_launch<192, 128, 32, 2, 2>(a, device, stream);
  if (dqk != dv) return cudaErrorInvalidValue;
  switch (dqk) {
    case 64:
      return f32_launch<64, 64, 32, 2, 2>(a, device, stream);
    case 128:
      return f32_launch<128, 128, 32, 2, 2>(a, device, stream);
    case 256:
      return f32_launch<256, 256, 16, 2, 2>(a, device, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, int DQK, int DV, int NC>
cudaError_t tc_launch(const Args& a, const CUtensorMap (&maps)[3], int device,
                      cudaStream_t stream) {
  using L = TcLayout<DQK, DV, NC>;
  auto kernel = flash_wgmma_kernel<T, DQK, DV, NC>;
  static PerDevice configured;  // the attribute, per kernel and device
  const cudaError_t err = configured.once(device, [&] {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  });
  if (err != cudaSuccess) return err;
  const int n_qt = (a.Tq + L::BQ - 1) / L::BQ;  // = ceil(ceil(Tq / 64) / NC)
  kernel<<<n_qt * a.B * a.H, L::THREADS, L::SMEM, stream>>>(maps[0], maps[1],
                                                           maps[2], a);
  return cudaGetLastError();
}

// The built head dims (dqk, dv) and tiles: (64, 64) and (128, 128) with
// 128 query rows (two consumer warpgroups), (256, 256) with 64 rows (one),
// (192, 128) with 128 rows (the output of dv 128, with Q 48 KB and the
// K/V rings 80 KB of shared memory); 64 keys.
template <typename T>
cudaError_t tc_dispatch(int dqk, int dv, int block_q, int block_k,
                        const Args& a, CUtensorMapDataType type, int device,
                        cudaStream_t stream) {
  const bool built = (dqk == dv && (dqk == 64 || dqk == 128 || dqk == 256)) ||
                     (dqk == 192 && dv == 128);
  if (!built || block_q != (dqk == 256 ? 64 : 128) || block_k != kBlockK)
    return cudaErrorInvalidValue;
  const cudaError_t bound = bind_context(device);
  if (bound != cudaSuccess) return bound;
  CUtensorMap maps[3];
  if (!encode(&maps[0], type, a.q, dqk, a.H, a.Tq, a.B, a.q_sh, a.q_st, a.q_sb) ||
      !encode(&maps[1], type, a.k, dqk, a.Kv, a.Tk, a.B, a.k_sh, a.k_st, a.k_sb) ||
      !encode(&maps[2], type, a.v, dv, a.Kv, a.Tk, a.B, a.v_sh, a.v_st, a.v_sb))
    return cudaErrorInvalidValue;
  if (dqk == 192) return tc_launch<T, 192, 128, 2>(a, maps, device, stream);
  switch (dqk) {
    case 64:
      return tc_launch<T, 64, 64, 2>(a, maps, device, stream);
    case 128:
      return tc_launch<T, 128, 128, 2>(a, maps, device, stream);
    default:
      return tc_launch<T, 256, 256, 1>(a, maps, device, stream);
  }
}

}  // namespace

// One call's sizes, strides and options, built once per call signature by
// the wrapper (its ctypes structure `_Params` has this layout), so that a
// launch passes six arguments rather than thirty.
struct Params {
  int64_t q_sb, q_st, q_sh;  // element strides: batch, token, head
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_st, o_sh;
  int32_t dtype;  // 0 float32 (the f32 route), 1 bfloat16, 2 float16
  int32_t B, Tq, Tk, H, Kv;
  int32_t dh;  // of q and k
  int32_t dv;  // of v and o
  int32_t causal;
  int32_t window;   // <= 0: none
  int32_t block_q;  // wgmma: 128 (dh 64, 128, 192) or 64 (dh 256); f32: 64
  int32_t block_k;  // wgmma: 64; f32: 64, or 32 at dh 256
  float scale;
  float softcap;   // <= 0: off
  int32_t device;  // the CUDA device of q, k, v and o
};

// o[b, t, h, :] = attention of q[b, t, h, :] over k/v[b, :, h / (H/Kv), :]
// on `stream`, without synchronising; q, k, v and o of p->dtype, the head
// dims contiguous.  A non-null `lse` (f32, (B, H, Tq) contiguous) also
// receives each row's log-sum-exp of its scaled (softcapped) scores over
// the keys it sees, which the backward pass recomputes P from.  Returns a cudaError_t (cudaErrorInvalidValue for an
// unsupported dtype, (dh, dv) or tile, or a layout TMA refuses).
static_assert(sizeof(Params) == 160 && offsetof(Params, dtype) == 96 &&
                  offsetof(Params, scale) == 144 &&
                  offsetof(Params, device) == 152,
              "Params must match the wrapper's ctypes structure");

extern "C" int flash_attention_launch(const Params* p, const void* q,
                                      const void* k, const void* v, void* o,
                                      float* lse, cudaStream_t stream) {
  if (p->B <= 0 || p->Tq <= 0) return cudaSuccess;
  if (p->Tk <= 0 || p->Kv <= 0 || p->H % p->Kv != 0 || p->device < 0 ||
      p->device >= kMaxDevices)
    return cudaErrorInvalidValue;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  const int64_t strides = p->q_sb | p->q_st | p->q_sh | p->k_sb | p->k_st | p->k_sh |
                          p->v_sb | p->v_st | p->v_sh;
  const int vec = bases % 16 == 0 && strides % 4 == 0;  // f32: 4 elements
  const Args a{q,        k,        v,        o,        lse,       p->q_sb,   p->q_st,
               p->q_sh,  p->k_sb,  p->k_st,  p->k_sh,  p->v_sb,   p->v_st,
               p->v_sh,  p->o_sb,  p->o_st,  p->o_sh,  p->B,      p->Tq,
               p->Tk,    p->H,     p->Kv,    p->scale, p->softcap, p->causal,
               p->window, vec};
  switch (p->dtype) {
    case 0:
      return f32_dispatch(p->dh, p->dv, p->block_q, p->block_k, a, p->device, stream);
    case 1:
      return tc_dispatch<__nv_bfloat16>(p->dh, p->dv, p->block_q, p->block_k,
                                        a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                        p->device, stream);
    case 2:
      return tc_dispatch<__half>(p->dh, p->dv, p->block_q, p->block_k, a,
                                 CU_TENSOR_MAP_DATA_TYPE_FLOAT16, p->device,
                                 stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
