// Mamba-2 SSD chunked scan for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `ssd` (src/repro/kernels/ssd/kernel.py,
// body `_kernel`), and computes what `ssd_reference` in ../ref.py computes
// (Dao & Gu, arXiv:2405.21060, Algorithm 1) for a single B/C group:
//   per (batch, head), chunks of Q positions in order, carrying a [P, N] f32
//   state; within a chunk, with cum = cumsum(dt * A):
//     y     = (C Bᵀ ∘ L) (x dt) + exp(cum) ∘ (C stateᵀ),  L[i,j] = exp(cum_i - cum_j), j <= i
//     state = state exp(cum_Q) + (x dt)ᵀ (B ∘ exp(cum_Q - cum))
//
// Layouts (the last dimension of every input has stride 1; the others are
// strides the wrapper passes, so slices of the model's fused projection
// need no copy):
//   x        [B, S, H, P]  f32 or bf16        y  [B, S, H, P] in x's type, contiguous
//   dt       [B, S, H]     f32 (post-softplus) A  [H] f32
//   Bm, Cm   [B, S, N]     f32 or bf16 (one group shared by every head)
//   final_state [B, H, P, N] f32, contiguous
// S need not be a multiple of Q: positions past S are read as dt = 0 and
// x = B = C = 0, which is the reference's zero padding (decay 1, no update),
// so y and the final state equal the padded computation's.
//
// What bounds it: bytes, once the products run on tensor cores. At the
// serving path's shape (mamba2-2.7b: H=80, P=64, N=128, Q=128, bf16) and
// S = 256, x, B, C, dt in and y and the final state out are ~8 MB (~2.4 us
// at 3.35 TB/s); the four products, ~5 M multiply-adds a (head, chunk),
// would take ~24 us on f32 CUDA cores at their peak and ~0.4 us on bf16
// tensor cores.
//
// Two routes, chosen by the wrapper from dtypes and shapes (ops._route):
//
// Tensor cores (bf16 x and B/C, P and N multiples of 16, Q a multiple of
// 64, 16-byte aligned rows): SSD Algorithm 1 as three passes, the
// chunk-state / state-passing / chunk-scan split of the public Mamba-2
// implementation, all launched by the one C entry point below:
//   1. `ssd_tc_chunk_state_kernel`, grid (column ranges of N, H, B x chunks),
//      8 warps: a warp scan gives cum (prefix sum of dt*A) and the chunk's
//      total; the block writes cum to an f32 workspace and the chunk's state
//      xᵀ (B ∘ dt·exp(total - cum)) [P, range of N] to the workspace (the
//      last chunk's straight into final_state). A warp computes a tile of
//      16 rows of P by up to 64 columns.
//   2. `ssd_tc_state_pass_kernel`, grid (P·N / 1024, H, B), float4 a thread,
//      serial over chunks: carry = carry·exp(total_c) + state_c, written in
//      place, so slot c holds the state after chunk c, the state before
//      chunk c + 1; the last step adds final_state's chunk state. Not
//      launched for a one-chunk sequence: its state is the chunk's own.
//   3. `ssd_tc_output_kernel`, grid (row tiles x column ranges of P, H,
//      B x chunks), 4 warps of 16 rows: y = (C·Bᵀ ∘ L ∘ dt_j)·x over the
//      key tiles of 64 at or below the warp's rows, then, for chunks after
//      the first, + exp(cum) ∘ (C·stateᵀ). The scores stay in registers: the
//      accumulator of two 8-key tiles is the A fragment of one 16-key step.
//      The state is staged after the first term, into the shared memory
//      that B and x held.
// Products are `mma.sync.m16n8k16` bf16 -> f32 (helpers in ssd_mma.cuh,
// shared with the backward) from `ldmatrix` fragments of padded shared
// rows (16 bytes of padding put the eight rows an `ldmatrix` reads in
// distinct banks), loaded with 16-byte `cp.async`
// (zero-filled past S). x, B and C are operands as they come. The three
// operands computed in f32 (B ∘ dt·exp(total - cum), the masked scores
// times dt, the carried state) enter as two bf16 products, hi = bf16(v)
// and lo = bf16(v - hi), which keeps ~16 bits of their mantissa: one bf16
// rounding of the scores would put an error of ~1e-3 of the largest terms
// on outputs that cancel to near zero, beyond the reference's 2e-2 band at
// its own test scales. ref.ssd_chunked_passes_ref(split_operands=True) is
// this computation in plain PyTorch. ops._scan_plan cuts the grid so a
// one-chunk prefill (80 heads) still gives each pass 160 blocks.
//   What the chip runs taught (H100, mamba2's shape): the passes are bound
// by latency, not by their products or bytes: a block's loads, scan and
// products run one after another with few warps an SM to hide them. So
// shared memory sets the time: the chunk pass over 64 columns of N (~56
// KB, four blocks an SM) beats one over 128 (~89 KB, two) although it
// loads x twice, and staging the state where B and x were (~70 KB, three
// blocks an SM, from ~104 KB and two) made the output pass faster at every
// S with more than one chunk. More blocks with less work each did not
// help: cutting P in the output pass recomputes C·Bᵀ per range and was
// slower at every S.
// Key tiles are computed whole, the part past the diagonal masked, which
// is cheaper than branching per 16 keys. C·Bᵀ is computed per head, as the
// Pallas kernel did: a block that shared it across heads would hold
// several heads' x and outputs, fewer blocks an SM.
//
// CUDA cores (everything else: f32 or mixed dtypes, other widths or
// chunks, unaligned rows): `ssd_kernel`, the first port's kernel. One block
// per (head, batch row) with a loop over chunks inside the block, in place
// of the Pallas grid's sequential chunk axis and its VMEM scratch; the
// [P, N] state lives in shared memory (33 KB at P=64, N=128). Per chunk the
// block stages dt, the prefix sum cum (one warp scan) and x·dt [Q, P] in
// shared memory, then walks the chunk's rows in tiles of 32: a C tile gives
// the inter-chunk term from the state, then for every B tile at or below it
// the masked scores (C·Bᵀ∘L, computed only where j <= i) and their product
// with x·dt. After every row of the chunk has read the old state, B tiles
// scaled by exp(cum_Q - cum) update it. All products run in f32 with row
// strides padded by one float against bank conflicts; ~110 KB of shared
// memory at the serving shape, 80 blocks at mamba2's shape.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "ssd_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;  // chunk rows per C / B tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides {
  long long x_b, x_s, x_h;  // x    (p stride 1)
  long long dt_b, dt_s;     // dt   (h stride 1)
  long long b_b, b_s;       // Bm   (n stride 1)
  long long c_b, c_s;       // Cm   (n stride 1)
};

template <typename XT, typename BT>
__global__ void __launch_bounds__(kThreads) ssd_kernel(
    const XT* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const BT* __restrict__ Bm, const BT* __restrict__ Cm, XT* __restrict__ y,
    float* __restrict__ final_state, int S, int H, int P, int N, int Q, Strides st) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int NP = N + 1;       // padded row stride of the state and the B/C tiles
  const int SP = kTile + 1;   // padded row stride of the score tile

  extern __shared__ float smem[];
  float* state_s = smem;                 // [P, N+1]
  float* xdt_s = state_s + P * NP;       // [Q, P]
  float* cum_s = xdt_s + Q * P;          // [Q]
  float* dt_s = cum_s + Q;               // [Q]
  float* c_s = dt_s + Q;                 // [kTile, N+1]
  float* b_s = c_s + kTile * NP;         // [kTile, N+1]
  float* s_s = b_s + kTile * NP;         // [kTile, kTile+1]
  float* y_s = s_s + kTile * SP;         // [kTile, P]

  const float a = A[h];
  const XT* xb = x + b * st.x_b + h * st.x_h;
  const float* dtb = dt + b * st.dt_b + h;
  const BT* Bb = Bm + b * st.b_b;
  const BT* Cb = Cm + b * st.c_b;
  XT* yb = y + ((size_t)b * S * H + h) * P;

  for (int i = tid; i < P * NP; i += kThreads) state_s[i] = 0.f;

  const int n_chunks = (S + Q - 1) / Q;
  for (int c = 0; c < n_chunks; ++c) {
    const int s0 = c * Q;
    __syncthreads();  // the previous chunk is done with dt_s, cum_s, xdt_s, b_s
    for (int q = tid; q < Q; q += kThreads) dt_s[q] = s0 + q < S ? dtb[(s0 + q) * st.dt_s] : 0.f;
    __syncthreads();

    // cum = inclusive prefix sum of dt*A: each lane of warp 0 sums a run of
    // the chunk, then a shuffle scan adds the runs before it
    if (tid < 32) {
      const int per = (Q + 31) / 32;
      const int lo = min(Q, tid * per), hi = min(Q, lo + per);
      float run = 0.f;
      for (int q = lo; q < hi; ++q) {
        run += dt_s[q] * a;
        cum_s[q] = run;
      }
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const float base = incl - run;
      for (int q = lo; q < hi; ++q) cum_s[q] += base;
    }
    for (int i = tid; i < Q * P; i += kThreads) {
      const int q = i / P, p = i - q * P;
      xdt_s[i] = s0 + q < S ? to_f32(xb[(s0 + q) * st.x_s + p]) * dt_s[q] : 0.f;
    }

    // ---- y, one tile of kTile rows at a time
    for (int i0 = 0; i0 < Q; i0 += kTile) {
      const int ti = min(kTile, Q - i0);
      __syncthreads();  // cum_s/xdt_s written; c_s free
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int r = i / N, n = i - r * N;
        const int pos = s0 + i0 + r;
        c_s[r * NP + n] = r < ti && pos < S ? to_f32(Cb[pos * st.c_s + n]) : 0.f;
      }
      __syncthreads();
      // inter-chunk term from the carried state: exp(cum_i) * C_i · state_p
      for (int i = tid; i < kTile * P; i += kThreads) {
        const int r = i / P, p = i - r * P;
        float acc = 0.f;
        if (r < ti) {
          for (int n = 0; n < N; ++n) acc += c_s[r * NP + n] * state_s[p * NP + n];
          acc *= expf(cum_s[i0 + r]);
        }
        y_s[i] = acc;
      }
      // intra-chunk term over the B tiles at or below this row tile
      for (int j0 = 0; j0 <= i0; j0 += kTile) {
        const int tj = min(kTile, Q - j0);
        for (int i = tid; i < kTile * N; i += kThreads) {
          const int r = i / N, n = i - r * N;
          const int pos = s0 + j0 + r;
          b_s[r * NP + n] = r < tj && pos < S ? to_f32(Bb[pos * st.b_s + n]) : 0.f;
        }
        __syncthreads();  // b_s loaded; every thread is done reading s_s
        for (int i = tid; i < kTile * kTile; i += kThreads) {
          const int r = i / kTile, jj = i - r * kTile;
          const int qi = i0 + r, qj = j0 + jj;
          float sc = 0.f;
          if (r < ti && jj < tj && qj <= qi) {
            float acc = 0.f;
            for (int n = 0; n < N; ++n) acc += c_s[r * NP + n] * b_s[jj * NP + n];
            sc = acc * expf(cum_s[qi] - cum_s[qj]);
          }
          s_s[r * SP + jj] = sc;
        }
        __syncthreads();
        for (int i = tid; i < kTile * P; i += kThreads) {
          const int r = i / P, p = i - r * P;
          float acc = y_s[i];
          for (int jj = 0; jj < tj; ++jj) acc += s_s[r * SP + jj] * xdt_s[(j0 + jj) * P + p];
          y_s[i] = acc;
        }
        __syncthreads();  // b_s free for the next tile
      }
      for (int i = tid; i < kTile * P; i += kThreads) {
        const int r = i / P, p = i - r * P;
        const int pos = s0 + i0 + r;
        if (r < ti && pos < S) yb[(size_t)pos * H * P + p] = from_f32<XT>(y_s[i]);
      }
    }

    // ---- state update, after every row of the chunk read the old state
    __syncthreads();
    const float total = cum_s[Q - 1];
    const float decay = expf(total);
    for (int i = tid; i < P * N; i += kThreads) {
      const int p = i / N, n = i - p * N;
      state_s[p * NP + n] *= decay;
    }
    for (int j0 = 0; j0 < Q; j0 += kTile) {
      const int tj = min(kTile, Q - j0);
      __syncthreads();  // b_s free
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int r = i / N, n = i - r * N;
        const int pos = s0 + j0 + r;
        b_s[r * NP + n] = r < tj && pos < S
                              ? to_f32(Bb[pos * st.b_s + n]) * expf(total - cum_s[j0 + r])
                              : 0.f;
      }
      __syncthreads();
      for (int i = tid; i < P * N; i += kThreads) {
        const int p = i / N, n = i - p * N;
        float acc = state_s[p * NP + n];
        for (int jj = 0; jj < tj; ++jj) acc += xdt_s[(j0 + jj) * P + p] * b_s[jj * NP + n];
        state_s[p * NP + n] = acc;
      }
    }
  }

  __syncthreads();
  float* fs = final_state + ((size_t)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    fs[i] = state_s[p * NP + n];
  }
}

template <typename XT, typename BT>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                   void* y, void* final_state, int Bsz, int S, int H, int P, int N, int Q,
                   const Strides& st, size_t smem, cudaStream_t stream) {
  auto kernel = ssd_kernel<XT, BT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(H, Bsz), kThreads, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const BT*>(Bm), static_cast<const BT*>(Cm), static_cast<XT*>(y),
      static_cast<float*>(final_state), S, H, P, N, Q, st);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch_bc(int bc_dtype, const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, void* y, void* final_state, int Bsz,
                        int S, int H, int P, int N, int Q, const Strides& st, size_t smem,
                        cudaStream_t stream) {
  switch (bc_dtype) {
    case 0:
      return launch<XT, float>(x, dt, A, Bm, Cm, y, final_state, Bsz, S, H, P, N, Q, st, smem,
                               stream);
    case 1:
      return launch<XT, __nv_bfloat16>(x, dt, A, Bm, Cm, y, final_state, Bsz, S, H, P, N, Q,
                                       st, smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}


// ------------------------------------------------------------ tensor cores
constexpr int kTcWarps = 4;                 // output pass: 16 rows a warp
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kRowTile = 16 * kTcWarps;     // chunk rows an output-pass block covers
constexpr int kChunkWarps = 8;              // chunk pass
constexpr int kChunkThreads = 32 * kChunkWarps;
constexpr int kStateThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

struct TcParams {
  int S, H, P, N, Q, C;  // C: chunks
  int nw, pw;            // columns of N a chunk-pass block, of P an output-pass block
  int p_splits;
  Strides st;
};

// cum_s[q] = dt_s[0] a + ... + dt_s[q] a over the chunk, by warp 0: each lane
// sums a run, then a shuffle scan adds the runs before it
__device__ __forceinline__ void chunk_cumsum(const float* dt_s, float a, float* cum_s, int Q,
                                             int tid) {
  if (tid >= 32) return;
  const int per = (Q + 31) / 32;
  const int lo = min(Q, tid * per), hi = min(Q, lo + per);
  float run = 0.f;
  for (int q = lo; q < hi; ++q) {
    run += dt_s[q] * a;
    cum_s[q] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (tid >= off) incl += v;
  }
  const float base = incl - run;
  for (int q = lo; q < hi; ++q) cum_s[q] += base;
}

// Pass 1, one block per (column range of N, head, batch row x chunk): cum to
// the workspace (by the first range), and the chunk's state
// xᵀ (B ∘ dt·exp(total - cum)) [P, nw] to its slot (the last chunk's to
// final_state, which the state pass completes).
__global__ void __launch_bounds__(kChunkThreads) ssd_tc_chunk_state_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
    float* __restrict__ cum_ws, float* __restrict__ states, float* __restrict__ final_state,
    TcParams pr) {
  const int h = blockIdx.y, b = blockIdx.z / pr.C, c = blockIdx.z % pr.C;
  const int Q = pr.Q, P = pr.P, N = pr.N, nw = pr.nw, n0 = blockIdx.x * nw;
  const int XR = P + 8, BR = nw + 8;  // padded shared rows, elements
  const int s0 = c * Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [Q][XR]
  __nv_bfloat16* bhi_s = x_s + Q * XR;                               // [Q][BR]
  __nv_bfloat16* blo_s = bhi_s + Q * BR;                             // [Q][BR]
  float* cum_s = reinterpret_cast<float*>(blo_s + Q * BR);           // [Q]
  float* w_s = cum_s + Q;                                            // [Q]: dt, then the weights

  const __nv_bfloat16* xb = x + b * pr.st.x_b + h * pr.st.x_h;
  const __nv_bfloat16* Bb = Bm + b * pr.st.b_b + n0;
  for (int i = tid; i < Q * (P / 8); i += kChunkThreads) {
    const int r = i / (P / 8), col = (i - r * (P / 8)) * 8;
    const bool ok = s0 + r < pr.S;
    cp_async16(x_s + r * XR + col, ok ? xb + (long long)(s0 + r) * pr.st.x_s + col : xb, ok);
  }
  for (int i = tid; i < Q * (nw / 8); i += kChunkThreads) {
    const int r = i / (nw / 8), col = (i - r * (nw / 8)) * 8;
    const bool ok = s0 + r < pr.S;
    cp_async16(bhi_s + r * BR + col, ok ? Bb + (long long)(s0 + r) * pr.st.b_s + col : Bb, ok);
  }
  cp_async_commit();
  const float* dtb = dt + b * pr.st.dt_b + h;
  for (int q = tid; q < Q; q += kChunkThreads)
    w_s[q] = s0 + q < pr.S ? dtb[(long long)(s0 + q) * pr.st.dt_s] : 0.f;
  __syncthreads();
  chunk_cumsum(w_s, A[h], cum_s, Q, tid);
  __syncthreads();
  const float total = cum_s[Q - 1];
  if (blockIdx.x == 0) {
    float* cw = cum_ws + ((size_t)blockIdx.z * pr.H + h) * Q;
    for (int q = tid; q < Q; q += kChunkThreads) cw[q] = cum_s[q];
  }
  for (int q = tid; q < Q; q += kChunkThreads) w_s[q] *= expf(total - cum_s[q]);
  cp_async_wait<0>();
  __syncthreads();
  // B ∘ w as hi + lo bf16 pairs, hi in place
  for (int i = tid; i < Q * (nw / 2); i += kChunkThreads) {
    const int r = i / (nw / 2), col = (i - r * (nw / 2)) * 2;
    __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(bhi_s + r * BR + col);
    const float2 v = __bfloat1622float2(*hp);
    const float w = w_s[r];
    __nv_bfloat162 hi, lo;
    split_bf16(v.x * w, v.y * w, hi, lo);
    *hp = hi;
    *reinterpret_cast<__nv_bfloat162*>(blo_s + r * BR + col) = lo;
  }
  __syncthreads();

  // state[p, n] = sum_j x[j, p] Bw[j, n]: A = xᵀ (ldmatrix.trans of x's rows),
  // B = Bw (ldmatrix.trans); a warp takes a tile of 16 rows of P by 64
  // columns at a time
  float* out = c == pr.C - 1 ? final_state + ((size_t)b * pr.H + h) * P * N
                             : states + (((size_t)b * (pr.C - 1) + c) * pr.H + h) * P * N;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_tiles = (nw + 63) / 64;
  for (int item = warp; item < (P / 16) * n_tiles; item += kChunkWarps) {
    const int pt = item / n_tiles, nb = (item - pt * n_tiles) * 64;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k = 0; k < Q; k += 16) {
      uint32_t af[4];
      ldmatrix_x4_trans(af, x_s + (k + (lane & 7) + ((lane >> 4) << 3)) * XR + pt * 16 +
                                ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (nb + 16 * j < nw) {
          const int off =
              (k + (lane & 7) + ((lane >> 3) & 1) * 8) * BR + nb + 16 * j + (lane >> 4) * 8;
          uint32_t bh[4], bl[4];
          ldmatrix_x4_trans(bh, bhi_s + off);
          ldmatrix_x4_trans(bl, blo_s + off);
          mma_bf16(acc[2 * j], af, bh[0], bh[1]);
          mma_bf16(acc[2 * j + 1], af, bh[2], bh[3]);
          mma_bf16(acc[2 * j], af, bl[0], bl[1]);
          mma_bf16(acc[2 * j + 1], af, bl[2], bl[3]);
        }
      }
    }
    const int p = pt * 16 + g;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (nb + 8 * j < nw) {
        const int n = n0 + nb + 8 * j + 2 * t4;
        *reinterpret_cast<float2*>(out + (size_t)p * N + n) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(out + (size_t)(p + 8) * N + n) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
  }
}

// Pass 2, a thread per 4 state elements of a (head, batch row), serial over
// chunks: carry = carry·exp(total_c) + state_c, written back to each slot.
__global__ void __launch_bounds__(kStateThreads) ssd_tc_state_pass_kernel(
    const float* __restrict__ cum_ws, float* __restrict__ states,
    float* __restrict__ final_state, TcParams pr) {
  const int e = blockIdx.x * kStateThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t PN = (size_t)pr.P * pr.N;
  if (e >= (int)(PN / 4)) return;
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < pr.C; ++c) {
    const float decay = expf(cum_ws[(((size_t)b * pr.C + c) * pr.H + h) * pr.Q + pr.Q - 1]);
    float* slot = c == pr.C - 1 ? final_state + ((size_t)b * pr.H + h) * PN
                                : states + (((size_t)b * (pr.C - 1) + c) * pr.H + h) * PN;
    float4* s4 = reinterpret_cast<float4*>(slot) + e;
    const float4 v = *s4;
    carry = make_float4(carry.x * decay + v.x, carry.y * decay + v.y, carry.z * decay + v.z,
                        carry.w * decay + v.w);
    *s4 = carry;
  }
}

// Pass 3, one block per (row tile x column range of P, head, batch row x
// chunk), a warp per 16 rows: y = sum_{j <= i} (C_i · B_j) exp(cum_i - cum_j)
// dt_j x_j + exp(cum_i) (C_i · state_pᵀ). The state, for chunks after the
// first, is staged after the intra-chunk term into the shared memory B and
// x held, which keeps a block at ~72 KB (three blocks an SM) at the serving
// shape.
__global__ void __launch_bounds__(kTcThreads) ssd_tc_output_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ Cm,
    const float* __restrict__ cum_ws, const float* __restrict__ states,
    __nv_bfloat16* __restrict__ y, TcParams pr) {
  const int tile = blockIdx.x / pr.p_splits;
  const int h = blockIdx.y, b = blockIdx.z / pr.C, c = blockIdx.z % pr.C;
  const int Q = pr.Q, N = pr.N, pw = pr.pw, p0 = (blockIdx.x % pr.p_splits) * pw;
  const int s0 = c * Q, i0 = tile * kRowTile;
  if (s0 + i0 >= pr.S) return;
  const int jn = i0 + kRowTile;  // key rows the tile's rows can see
  const int CR = N + 8, XR = pw + 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* c_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRowTile][CR]
  __nv_bfloat16* b_s = c_s + kRowTile * CR;                          // [Q][CR]
  __nv_bfloat16* x_s = b_s + Q * CR;                                 // [Q][XR]
  __nv_bfloat16* shi_s = b_s;                                        // [pw][CR], after B, x
  __nv_bfloat16* slo_s = shi_s + pw * CR;                            // [pw][CR]
  float* cum_s = reinterpret_cast<float*>(b_s + max(Q * (CR + XR), 2 * pw * CR));  // [Q]
  float* dt_s = cum_s + Q;                                           // [Q]

  const __nv_bfloat16* Cb = Cm + b * pr.st.c_b;
  const __nv_bfloat16* Bb = Bm + b * pr.st.b_b;
  const __nv_bfloat16* xb = x + b * pr.st.x_b + h * pr.st.x_h + p0;
  for (int i = tid; i < kRowTile * (N / 8); i += kTcThreads) {
    const int r = i / (N / 8), col = (i - r * (N / 8)) * 8;
    const int pos = s0 + i0 + r;
    const bool ok = pos < pr.S;
    cp_async16(c_s + r * CR + col, ok ? Cb + (long long)pos * pr.st.c_s + col : Cb, ok);
  }
  for (int i = tid; i < jn * (N / 8); i += kTcThreads) {
    const int r = i / (N / 8), col = (i - r * (N / 8)) * 8;
    const bool ok = s0 + r < pr.S;
    cp_async16(b_s + r * CR + col, ok ? Bb + (long long)(s0 + r) * pr.st.b_s + col : Bb, ok);
  }
  for (int i = tid; i < jn * (pw / 8); i += kTcThreads) {
    const int r = i / (pw / 8), col = (i - r * (pw / 8)) * 8;
    const bool ok = s0 + r < pr.S;
    cp_async16(x_s + r * XR + col, ok ? xb + (long long)(s0 + r) * pr.st.x_s + col : xb, ok);
  }
  cp_async_commit();
  const float* cw = cum_ws + ((size_t)blockIdx.z * pr.H + h) * Q;
  const float* dtb = dt + b * pr.st.dt_b + h;
  for (int q = tid; q < Q; q += kTcThreads) {
    cum_s[q] = cw[q] * kLog2e;
    dt_s[q] = s0 + q < pr.S ? dtb[(long long)(s0 + q) * pr.st.dt_s] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  const int wr = i0 + 16 * warp;  // the warp's first row within the chunk
  const bool live = s0 + wr < pr.S;
  const int g = lane >> 2, t4 = lane & 3;
  const int ci0 = wr + g, ci1 = wr + g + 8;  // this lane's two rows
  const __nv_bfloat16* c_warp = c_s + (16 * warp + (lane & 15)) * CR + (lane >> 4) * 8;
  const float cr0 = cum_s[ci0], cr1 = cum_s[ci1];
  float o[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;

  // the intra-chunk term over key tiles of 64 at or below the warp's rows;
  // a tile's keys past the diagonal are loaded (zero past S) and masked
  for (int j0 = 0; live && j0 < wr + 16; j0 += 64) {
    float s[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
    for (int k = 0; k < N; k += 16) {
      uint32_t af[4];
      ldmatrix_x4(af, c_warp + k);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, b_s + (j0 + 16 * np + (lane & 7) + ((lane >> 4) << 3)) * CR + k +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], af, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], af, bf[2], bf[3]);
      }
    }
    // times L_ij dt_j, zero above the diagonal: one flat loop
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = j0 + 8 * t + 2 * t4 + e;
        const float cj = cum_s[j], dj = dt_s[j];
        s[t][e] = j <= ci0 ? s[t][e] * (exp2f(cr0 - cj) * dj) : 0.f;
        s[t][2 + e] = j <= ci1 ? s[t][2 + e] * (exp2f(cr1 - cj) * dj) : 0.f;
      }
    // O += S · x: two 8-key accumulator tiles are one 16-key A fragment,
    // split hi + lo; x's B fragments from ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split_pack(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pack(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pack(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_pack(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        if (16 * dp < pw) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, x_s + (j0 + 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * XR +
                                    16 * dp + (lane >> 4) * 8);
          mma_bf16(o[2 * dp], ph, bf[0], bf[1]);
          mma_bf16(o[2 * dp + 1], ph, bf[2], bf[3]);
          mma_bf16(o[2 * dp], pl, bf[0], bf[1]);
          mma_bf16(o[2 * dp + 1], pl, bf[2], bf[3]);
        }
      }
    }
  }

  if (c > 0) {  // + exp(cum_i) C_i · stateᵀ, the state as hi + lo bf16 pairs
    __syncthreads();  // every warp is done with B and x
    const float4* src = reinterpret_cast<const float4*>(
        states + ((((size_t)b * (pr.C - 1) + c - 1) * pr.H + h) * pr.P + p0) * N);
    for (int i = tid; i < pw * (N / 4); i += kTcThreads) {
      const int r = i / (N / 4), col = (i - r * (N / 4)) * 4;
      const float4 v = src[(size_t)r * (N / 4) + col / 4];
      __nv_bfloat162 h0, l0, h1, l1;
      split_bf16(v.x, v.y, h0, l0);
      split_bf16(v.z, v.w, h1, l1);
      __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(shi_s + r * CR + col);
      __nv_bfloat162* lp = reinterpret_cast<__nv_bfloat162*>(slo_s + r * CR + col);
      hp[0] = h0;
      hp[1] = h1;
      lp[0] = l0;
      lp[1] = l1;
    }
    __syncthreads();
    if (live) {
      float so[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t) so[t][0] = so[t][1] = so[t][2] = so[t][3] = 0.f;
      for (int k = 0; k < N; k += 16) {
        uint32_t af[4];
        ldmatrix_x4(af, c_warp + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (16 * j < pw) {
            const int off = (16 * j + (lane & 7) + ((lane >> 4) << 3)) * CR + k +
                            ((lane >> 3) & 1) * 8;
            uint32_t bh[4], bl[4];
            ldmatrix_x4(bh, shi_s + off);
            ldmatrix_x4(bl, slo_s + off);
            mma_bf16(so[2 * j], af, bh[0], bh[1]);
            mma_bf16(so[2 * j + 1], af, bh[2], bh[3]);
            mma_bf16(so[2 * j], af, bl[0], bl[1]);
            mma_bf16(so[2 * j + 1], af, bl[2], bl[3]);
          }
        }
      }
      const float e0 = exp2f(cr0), e1 = exp2f(cr1);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        o[t][0] += e0 * so[t][0];
        o[t][1] += e0 * so[t][1];
        o[t][2] += e1 * so[t][2];
        o[t][3] += e1 * so[t][3];
      }
    }
  }
  if (!live) return;

  __nv_bfloat16* yb = y + ((size_t)b * pr.S * pr.H + h) * pr.P + p0;
  const size_t row = (size_t)pr.H * pr.P;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    if (8 * t < pw) {
      const int col = 8 * t + 2 * t4;
      if (s0 + ci0 < pr.S)
        *reinterpret_cast<__nv_bfloat162*>(yb + (s0 + ci0) * row + col) =
            __floats2bfloat162_rn(o[t][0], o[t][1]);
      if (s0 + ci1 < pr.S)
        *reinterpret_cast<__nv_bfloat162*>(yb + (s0 + ci1) * row + col) =
            __floats2bfloat162_rn(o[t][2], o[t][3]);
    }
  }
}

size_t tc_state_smem(int P, int Q, int nw) {
  return 2 * ((size_t)Q * (P + 8) + 2 * (size_t)Q * (nw + 8)) + 8 * (size_t)Q;
}
size_t tc_output_smem(int N, int Q, int pw) {
  const size_t CR = N + 8, XR = pw + 8;
  return 2 * (kRowTile * CR + std::max(Q * (CR + XR), 2 * pw * CR)) + 8 * (size_t)Q;
}

cudaError_t launch_tc(const void* x, const void* dt, const void* A, const void* Bm,
                      const void* Cm, void* y, void* final_state, void* workspace, int Bsz, int S,
                      int H, int P, int N, int Q, const Strides& st, int state_splits,
                      int p_splits, cudaStream_t stream) {
  if (state_splits <= 0 || p_splits <= 0 || P % 16 || N % 16 || Q % kRowTile ||
      N % (16 * state_splits) || P % (16 * p_splits) || P / p_splits > 64 || workspace == nullptr)
    return cudaErrorInvalidValue;
  const int C = (S + Q - 1) / Q;
  const TcParams pr{S, H, P, N, Q, C, N / state_splits, P / p_splits, p_splits, st};
  const size_t smem1 = tc_state_smem(P, Q, pr.nw), smem3 = tc_output_smem(N, Q, pr.pw);
  if (smem1 > 232448 || smem3 > 232448) return cudaErrorInvalidConfiguration;
  float* cum_ws = static_cast<float*>(workspace);           // [B, C, H, Q]
  float* states = cum_ws + (size_t)Bsz * C * H * Q;          // [B, C - 1, H, P, N]
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* bb = static_cast<const __nv_bfloat16*>(Bm);
  const auto* cb = static_cast<const __nv_bfloat16*>(Cm);
  const auto* dtf = static_cast<const float*>(dt);
  float* fs = static_cast<float*>(final_state);

  cudaError_t err = cudaFuncSetAttribute(
      ssd_tc_chunk_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_tc_output_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem3);
  if (err != cudaSuccess) return err;
  ssd_tc_chunk_state_kernel<<<dim3(state_splits, H, Bsz * C), kChunkThreads, smem1, stream>>>(
      xb, dtf, static_cast<const float*>(A), bb, cum_ws, states, fs, pr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (C > 1) {
    const int blocks = (P * N / 4 + kStateThreads - 1) / kStateThreads;
    ssd_tc_state_pass_kernel<<<dim3(blocks, H, Bsz), kStateThreads, 0, stream>>>(cum_ws, states,
                                                                                  fs, pr);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  ssd_tc_output_kernel<<<dim3((Q / kRowTile) * p_splits, H, Bsz * C), kTcThreads, smem3,
                         stream>>>(xb, dtf, bb, cb, cum_ws, states,
                                   static_cast<__nv_bfloat16*>(y), pr);
  return cudaGetLastError();
}

}  // namespace

// Shared memory one block needs, in bytes.
extern "C" size_t ssd_smem(int P, int N, int Q) {
  const size_t NP = (size_t)N + 1;
  return sizeof(float) * ((size_t)P * NP + (size_t)Q * P + 2 * (size_t)Q + 2 * kTile * NP +
                          (size_t)kTile * (kTile + 1) + (size_t)kTile * P);
}

// Plain C entry point, bound with ctypes. dtype codes: 0 float32, 1 bfloat16;
// route: 0 the CUDA-core kernel, 1 the tensor-core passes (bf16 x and B/C;
// `workspace` holds ops._workspace_bytes, `state_splits` and `p_splits`
// come from ops._scan_plan; all three are unused by route 0). Strides are
// in elements. Returns the first launch's error (cudaGetLastError(), or
// the error of setting a kernel's shared-memory limit).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                        const void* Cm, void* y, void* final_state, void* workspace, int Bsz,
                        int S, int H, int P, int N, int Q, int x_dtype, int bc_dtype,
                        long long x_sb, long long x_ss, long long x_sh, long long dt_sb,
                        long long dt_ss, long long b_sb, long long b_ss, long long c_sb,
                        long long c_ss, int route, int state_splits, int p_splits,
                        void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0) return cudaErrorInvalidValue;
  const Strides st{x_sb, x_ss, x_sh, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (x_dtype != 1 || bc_dtype != 1) return cudaErrorInvalidValue;
    return launch_tc(x, dt, A, Bm, Cm, y, final_state, workspace, Bsz, S, H, P, N, Q, st,
                     state_splits, p_splits, s);
  }
  if (route != 0) return cudaErrorInvalidValue;
  const size_t smem = ssd_smem(P, N, Q);
  if (smem > 232448) return cudaErrorInvalidConfiguration;
  switch (x_dtype) {
    case 0:
      return dispatch_bc<float>(bc_dtype, x, dt, A, Bm, Cm, y, final_state, Bsz, S, H, P, N, Q,
                                st, smem, s);
    case 1:
      return dispatch_bc<__nv_bfloat16>(bc_dtype, x, dt, A, Bm, Cm, y, final_state, Bsz, S, H,
                                        P, N, Q, st, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}
