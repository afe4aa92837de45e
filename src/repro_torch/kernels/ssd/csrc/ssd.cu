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
// What bounds it: operations. Per (head, chunk) at the serving path's shape
// (P=64, N=128, Q=128) the four products C·Bᵀ (Q²N/2 useful), (C·Bᵀ∘L)·xdt
// (Q²P/2), C·stateᵀ (QPN) and xdtᵀ·B (QPN) are ~5 M multiply-adds; against
// the bytes (x, B, C, dt in, y and the state out: ~8 MB for 80 heads at
// S=256) the f32 work on CUDA cores is the larger bound, and the tensor cores
// would make it bytes.
//
// Design, simple and right first: one block per (head, batch row) with a
// loop over chunks inside the block, in place of the Pallas grid's
// sequential chunk axis and its VMEM scratch; the [P, N] state lives in
// shared memory (33 KB at P=64, N=128). Per chunk the block stages dt, the
// prefix sum cum (one warp scan) and x·dt [Q, P] in shared memory, then walks
// the chunk's rows in tiles of 32: a C tile gives the inter-chunk term from
// the state, then for every B tile at or below it the masked scores
// (C·Bᵀ∘L, computed only where j <= i, so L is never held whole: a Q×Q f32
// L at Q=128 would be 64 KB) and their product with x·dt. After every row
// of the chunk has read the old state, B tiles scaled by exp(cum_Q - cum)
// update it. All products run on CUDA cores in f32 with row strides padded
// by one float against bank conflicts; ~110 KB of shared memory at the
// serving shape.
//
// First thing for a later redesign: C·Bᵀ does not depend on the head (one
// group), yet every one of the H blocks recomputes it, as the Pallas kernel
// did: compute it once per (batch, chunk) and share it across the heads,
// and move the four products to bf16 tensor cores (wgmma).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

// Shared memory one block needs, in bytes.
extern "C" size_t ssd_smem(int P, int N, int Q) {
  const size_t NP = (size_t)N + 1;
  return sizeof(float) * ((size_t)P * NP + (size_t)Q * P + 2 * (size_t)Q + 2 * kTile * NP +
                          (size_t)kTile * (kTile + 1) + (size_t)kTile * P);
}

// Plain C entry point, bound with ctypes. dtype codes: 0 float32, 1 bfloat16.
// Strides are in elements. Returns the launch's cudaGetLastError() (or the
// error of setting the kernel's shared-memory limit).
extern "C" int ssd_scan(const void* x, const void* dt, const void* A, const void* Bm,
                        const void* Cm, void* y, void* final_state, int Bsz, int S, int H,
                        int P, int N, int Q, int x_dtype, int bc_dtype, long long x_sb,
                        long long x_ss, long long x_sh, long long dt_sb, long long dt_ss,
                        long long b_sb, long long b_ss, long long c_sb, long long c_ss,
                        void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0) return cudaErrorInvalidValue;
  const size_t smem = ssd_smem(P, N, Q);
  if (smem > 232448) return cudaErrorInvalidConfiguration;
  const Strides st{x_sb, x_ss, x_sh, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
