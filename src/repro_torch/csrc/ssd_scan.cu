// Mamba-2 SSD within-chunk step on Hopper (sm_90a), f32.
//
// For one chunk bc of Q positions and one head h:
//
//   y_diag[q, p] = sum_{j<=q} (C_q . B_j) exp(dA_cs[q] - dA_cs[j]) dt_j x_j[p]
//   S[p, n]      = sum_j exp(dA_cs[Q-1] - dA_cs[j]) dt_j x_j[p] B_j[n]
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py (ssd_chunk_fwd,
// pallas_call at line 80).  The TPU kernel takes a (BC, H / head_block)
// grid, builds the whole (Q, Q, head_block) decay tensor in VMEM and hands
// the products to the MXU; head_block (8) is a TPU tiling choice.  Here:
//
//   * one launch, grid (1 + ceil(Q / 64), H, BC).  Block x == 0 computes
//     the chunk state of (bc, h); block x == 1 + i computes rows
//     [64 t, 64 t + 64) of y_diag with t = ceil(Q/64) - 1 - i, so the
//     tiles with the most key tiles start first.  Any H works;
//   * a y block walks the 64-row key tiles up to the diagonal: C.B^T of
//     the tile pair, then the decay and dt, then the product with x, all
//     from shared memory with f32 CUDA-core FMAs;
//   * the decay's exponent is taken only where q >= j (and both rows are
//     inside Q): above the diagonal dA_cs[q] - dA_cs[j] > 0 can overflow,
//     and a 0/1 mask applied after exp would turn inf * 0 into NaN;
//   * rows past Q (a ragged chunk, any Q from 1 to 256) load as zeros and
//     are not written;
//   * every input is read through its strides: the model's single B/C
//     group comes with a head stride of 0, so no broadcast copy is made;
//   * every sum runs in a fixed order, with no atomics: the same inputs
//     give the same bytes, which lossless paging relies on.
//
// What bounds it: at the prefill's shape (BC 4, Q 256, H 80, P 64, N 128)
// the causal products are about 5 GFLOP and the traffic about 54 MB, so
// the memory rate.  This simple design reaches neither: its products run
// on CUDA cores from shared memory (wgmma, TMA and sharing C.B^T across
// the heads of a group are later work).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTile = 64;      // rows of a q tile and of a key tile
constexpr int kMaxQ = 256;

struct Args {
  const float* x;     // (BC, Q, H, P)
  const float* dt;    // (BC, Q, H)
  const float* dacs;  // (BC, Q, H)
  const float* b;     // (BC, Q, H, N)
  const float* c;     // (BC, Q, H, N)
  float* y;           // (BC, Q, H, P), contiguous
  float* s;           // (BC, H, P, N), contiguous
  int64_t x_sb, x_sq, x_sh;  // element strides
  int64_t dt_sb, dt_sq, dt_sh;
  int64_t da_sb, da_sq, da_sh;
  int64_t b_sb, b_sq, b_sh;
  int64_t c_sb, c_sq, c_sh;
  int Q, H;
};

// Shared memory of a y block, in floats: C and B tiles (64 x (N+1); the +1
// pad puts the 16 rows a half-warp reads in 16 banks), the weight tile
// (64 x 65), the x tile (64 x P), and dA_cs of the q rows, dA_cs and dt of
// the key rows.
template <int P, int N>
constexpr int diag_floats() {
  return 2 * kTile * (N + 1) + kTile * (kTile + 1) + kTile * P + 3 * kTile;
}

// ... of a state block: B and the decayed x of 64 key rows, their weights.
template <int P, int N>
constexpr int state_floats() {
  return kTile * N + kTile * P + kTile;
}

template <int P, int N>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) *
         (diag_floats<P, N>() > state_floats<P, N>() ? diag_floats<P, N>()
                                                     : state_floats<P, N>());
}

template <int P, int N>
__device__ void diag_block(const Args& a, int bc, int h, int qt,
                           float* smem) {
  constexpr int NS = N + 1;
  constexpr int WS = kTile + 1;
  constexpr int PC = P / 16;
  float* sC = smem;
  float* sB = sC + kTile * NS;
  float* sW = sB + kTile * NS;
  float* sX = sW + kTile * WS;
  float* sDq = sX + kTile * P;
  float* sDj = sDq + kTile;
  float* sDt = sDj + kTile;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = qt * kTile;
  const int qn = min(kTile, a.Q - q0);
  const float* cbase = a.c + bc * a.c_sb + h * a.c_sh;
  const float* bbase = a.b + bc * a.b_sb + h * a.b_sh;
  const float* xbase = a.x + bc * a.x_sb + h * a.x_sh;
  const float* dabase = a.dacs + bc * a.da_sb + h * a.da_sh;
  const float* dtbase = a.dt + bc * a.dt_sb + h * a.dt_sh;

  for (int i = tid; i < kTile * N; i += kThreads) {
    const int r = i / N, n = i % N;
    sC[r * NS + n] = r < qn ? cbase[(q0 + r) * a.c_sq + n] : 0.f;
  }
  if (tid < kTile) sDq[tid] = tid < qn ? dabase[(q0 + tid) * a.da_sq] : 0.f;

  float acc[4][PC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < PC; ++c) acc[r][c] = 0.f;

  for (int j0 = 0; j0 <= q0; j0 += kTile) {
    const int jn = min(kTile, a.Q - j0);
    __syncthreads();  // the previous key tile's reads are done
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int r = i / N, n = i % N;
      sB[r * NS + n] = r < jn ? bbase[(j0 + r) * a.b_sq + n] : 0.f;
    }
    for (int i = tid; i < kTile * P; i += kThreads) {
      const int r = i / P, p = i % P;
      sX[i] = r < jn ? xbase[(j0 + r) * a.x_sq + p] : 0.f;
    }
    if (tid < kTile) {
      sDj[tid] = tid < jn ? dabase[(j0 + tid) * a.da_sq] : 0.f;
      sDt[tid] = tid < jn ? dtbase[(j0 + tid) * a.dt_sq] : 0.f;
    }
    __syncthreads();

    // C.B^T for rows ty + 16 r, key rows tx + 16 c
    float cb[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) cb[r][c] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = sC[(ty + 16 * r) * NS + n];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = sB[(tx + 16 * c) * NS + n];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) cb[r][c] = fmaf(cv[r], bv[c], cb[r][c]);
    }
    // weights: decay and dt, the exponent taken only on and below the
    // diagonal, inside the chunk
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = tx + 16 * c;
        float w = 0.f;
        if (qi < qn && kj < jn && q0 + qi >= j0 + kj) {
          w = cb[r][c] * expf(sDq[qi] - sDj[kj]) * sDt[kj];
        }
        sW[qi * WS + kj] = w;
      }
    }
    __syncthreads();

    // y rows ty + 16 r, columns tx + 16 c, summed over the key tile in order
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float wv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) wv[r] = sW[(ty + 16 * r) * WS + j];
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        const float xv = sX[j * P + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(wv[r], xv, acc[r][c]);
      }
    }
  }

  const int64_t row = static_cast<int64_t>(a.H) * P;  // y is contiguous
  float* ybase = a.y + static_cast<int64_t>(bc) * a.Q * row +
                 static_cast<int64_t>(h) * P;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = ty + 16 * r;
    if (qi >= qn) continue;
#pragma unroll
    for (int c = 0; c < PC; ++c) {
      ybase[(q0 + qi) * row + tx + 16 * c] = acc[r][c];
    }
  }
}

template <int P, int N>
__device__ void state_block(const Args& a, int bc, int h, float* smem) {
  constexpr int PR = P / 16;
  constexpr int NC = N / 16;
  float* sB = smem;
  float* sX = sB + kTile * N;
  float* sD = sX + kTile * P;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float* bbase = a.b + bc * a.b_sb + h * a.b_sh;
  const float* xbase = a.x + bc * a.x_sb + h * a.x_sh;
  const float* dabase = a.dacs + bc * a.da_sb + h * a.da_sh;
  const float* dtbase = a.dt + bc * a.dt_sb + h * a.dt_sh;
  const float seg = dabase[(a.Q - 1) * a.da_sq];

  float acc[PR][NC];
#pragma unroll
  for (int r = 0; r < PR; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;

  for (int j0 = 0; j0 < a.Q; j0 += kTile) {
    const int jn = min(kTile, a.Q - j0);
    __syncthreads();  // the previous tile's reads are done
    if (tid < kTile) {
      // seg - dA_cs[j] <= 0 for a decaying chunk: every row is inside Q
      sD[tid] = tid < jn ? expf(seg - dabase[(j0 + tid) * a.da_sq]) *
                               dtbase[(j0 + tid) * a.dt_sq]
                         : 0.f;
    }
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int r = i / N, n = i % N;
      sB[i] = r < jn ? bbase[(j0 + r) * a.b_sq + n] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < kTile * P; i += kThreads) {
      const int r = i / P, p = i % P;
      sX[i] = r < jn ? xbase[(j0 + r) * a.x_sq + p] * sD[r] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float xv[PR];
#pragma unroll
      for (int r = 0; r < PR; ++r) xv[r] = sX[j * P + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float bv = sB[j * N + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < PR; ++r) acc[r][c] = fmaf(xv[r], bv, acc[r][c]);
      }
    }
  }

  float* sbase = a.s + (static_cast<int64_t>(bc) * a.H + h) * P * N;
#pragma unroll
  for (int r = 0; r < PR; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      sbase[(ty + 16 * r) * N + tx + 16 * c] = acc[r][c];
    }
}

template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(const Args a) {
  extern __shared__ float smem[];
  const int h = blockIdx.y;
  const int bc = blockIdx.z;
  if (blockIdx.x == 0) {
    state_block<P, N>(a, bc, h, smem);
  } else {
    const int n_tiles = gridDim.x - 1;
    diag_block<P, N>(a, bc, h, n_tiles - static_cast<int>(blockIdx.x), smem);
  }
}

template <int P, int N>
cudaError_t launch(const Args& a, int BC, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<P, N>();
  // above 48 KB only after opting in (on the current device)
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_chunk_kernel<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(1 + (a.Q + kTile - 1) / kTile, a.H, BC);
  ssd_chunk_kernel<P, N><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int P>
cudaError_t dispatch_n(int N, const Args& a, int BC, cudaStream_t stream) {
  switch (N) {
    case 16:
      return launch<P, 16>(a, BC, stream);
    case 32:
      return launch<P, 32>(a, BC, stream);
    case 64:
      return launch<P, 64>(a, BC, stream);
    case 128:
      return launch<P, 128>(a, BC, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// y_diag and the chunk states of (BC, Q, H) f32 inputs, on `stream`,
// without synchronising.  Strides in elements (the last dim of x, B and C
// contiguous; a head stride of 0 is allowed); y and s are contiguous
// outputs.  1 <= Q <= 256, P and N in {16, 32, 64, 128}.  Returns a
// cudaError_t.
extern "C" int ssd_chunk_launch(
    const float* x, const float* dt, const float* dacs, const float* b,
    const float* c, float* y, float* s, int64_t x_sb, int64_t x_sq,
    int64_t x_sh, int64_t dt_sb, int64_t dt_sq, int64_t dt_sh, int64_t da_sb,
    int64_t da_sq, int64_t da_sh, int64_t b_sb, int64_t b_sq, int64_t b_sh,
    int64_t c_sb, int64_t c_sq, int64_t c_sh, int BC, int Q, int H, int P,
    int N, cudaStream_t stream) {
  if (BC <= 0 || H <= 0) return cudaSuccess;
  if (Q < 1 || Q > kMaxQ || BC > 65535 || H > 65535) {
    return cudaErrorInvalidValue;
  }
  const Args a{x,     dt,    dacs,  b,     c,     y,     s,    x_sb,
               x_sq,  x_sh,  dt_sb, dt_sq, dt_sh, da_sb, da_sq, da_sh,
               b_sb,  b_sq,  b_sh,  c_sb,  c_sq,  c_sh,  Q,     H};
  switch (P) {
    case 16:
      return dispatch_n<16>(N, a, BC, stream);
    case 32:
      return dispatch_n<32>(N, a, BC, stream);
    case 64:
      return dispatch_n<64>(N, a, BC, stream);
    case 128:
      return dispatch_n<128>(N, a, BC, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* ssd_chunk_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
