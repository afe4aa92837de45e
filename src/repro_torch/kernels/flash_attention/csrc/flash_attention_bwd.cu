// Flash attention backward for Hopper (sm_90a), CUDA C++.
//
// Not a port of a TPU kernel: the reference trains through plain jnp
// (`repro.models.Model.loss` differentiates `blockwise_attention`), and its
// Pallas `flash_attention` has no backward. The port's forward runs the flash
// kernel (flash_attention.cu) on every attention layer, so its gradient is a
// kernel too. It computes what autograd through `blockwise_attention` in f32
// computes (`flash_attention_bwd_ref` in ../ref.py): given q, k, v, the
// forward's output O, its per-row log-sum-exp LSE (natural log, f32
// [B, H, Sq], written by the forward kernel) and dO,
//
//   s  = scale · q kᵀ;  with a softcap  t = tanh(s / cap), s' = cap · t
//   P  = exp(s' − LSE)                       (0 where the mask hides a key)
//   dV = Pᵀ dO,  dP = dO Vᵀ,  dS = P ∘ (dP − Di) [∘ (1 − t²)],  Di = rowsum(dO ∘ O)
//   dQ = scale · dS K,  dK = scale · dSᵀ Q
//
// causal or bidirectional, a sliding window, a softcap, GQA/MQA (query head
// h reads KV head h / (H/KH); dK and dV sum over the heads of a group),
// ragged Sq and Skv, Sq != Skv (cross attention), D in {32, 64, 128, 160,
// 256}, f32 or bf16 operands with every sum in f32 and dQ/dK/dV written in
// the operands' type. Layouts as the forward: each tensor is read or
// written through (batch, head, sequence) strides in elements, the head
// dimension contiguous, so [B, H, S, D] and [B, S, H, D] both work without a
// copy. Queries sit at positions 0..Sq-1 (no q_offset, no kv_lengths, no
// hole: the wrapper refuses them under gradient).
//
// Three passes, deterministic, with no atomics (a crash-restart on the card
// then retraces the same bits, and both layouts give the same bits):
//   (a) Di = rowsum(dO ∘ O) in f32, one warp a row;
//   (b) one block for each (kv tile, kv head, batch row): K and V stay
//       while the block walks the q tiles that can see them (causal and
//       window bounds) for each query head of the group, recomputing P and
//       dS and accumulating dV and dK in registers;
//   (c) one block for each (q tile, head, batch row): Q and dO stay while
//       the block walks the visible kv tiles, accumulating dQ.
// Each pass writes each output element once. Tiles that causality or the
// window hide entirely are never loaded.
//
// What bounds it: operations. At qwen1.5-0.5b's training shape (B = 4,
// S = 1024, 16x64, causal) the passes compute 7 products of 2·D operations
// for every visible (query, key) pair (S and dP twice, dV, dK, dQ), ~30
// GFLOP, against 50 MB of operands.
//
// Two routes, chosen by the wrapper (`route`) from dtype, D and alignment:
//
// tensor_core (bf16, D in {32, 64, 128}, every row start 16-byte aligned):
// FlashAttention-2's backward on `mma.sync.m16n8k16` (bf16 in, f32
// accumulate), built from the forward's parts (`cp_async16`, `ldmatrix`,
// `mma_bf16`, `pack_bf16`, `fast_tanh`, copied below). Blocks of 4 warps.
//   Pass (b): each warp owns 16 keys of the block's 64. K and V sit in
// shared memory (rows padded by 16 bytes, so an `ldmatrix` hits eight
// distinct banks); up to D = 64 each warp holds their A fragments in
// registers. The (head, q tile) pairs the tile must visit run as one flat
// list through a ring of two shared stages: Q, dO (16-byte `cp.async`,
// zero-filled past Sq) and the tile's LSE and Di (4-byte `cp.async`), so
// the next pair's copies fly while this one computes. The warp computes
// the scores transposed, Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (Q's and dO's B fragments
// from `ldmatrix`), so its rows are its own keys; Pᵀ and dSᵀ are formed in
// registers (LSE and Di of each column from shared memory), rounded to
// bf16, and become the A fragments of dV += Pᵀ·dO and dK += dSᵀ·Q directly
// (two 8-column accumulators make one 16-deep A fragment), with B from
// `ldmatrix.trans` of the same dO and Q tiles. Nothing goes back to shared
// memory. Blocks on the first kv tiles see the most q tiles under a causal
// mask, so the grid puts the kv tile slowest and they start first.
//   Pass (c): each warp owns 16 query rows of the block's 64; Q's and dO's
// A fragments stay in registers up to D = 64, K and V tiles come through
// the same kind of ring. S = Q·Kᵀ and dP = dO·Vᵀ, then P and dS in
// registers, then dQ += dS·K with dS as the bf16 A fragment and K's B
// fragments from `ldmatrix.trans`. The q tiles with the longest causal
// rows start first.
//   Both passes scale, cap and mask as the forward learned to: one flat
// loop each (a branch-free tanh for the softcap; per-row bounds, and only
// on tiles that hold a masked entry), so the unrolled body stays small.
// The exponent is base 2 against LSE·log2(e); a row that sees no key
// (LSE = -inf) is read as +inf, so its P is 0 with no NaN. The softcap's
// factor 1 − t² is recovered from the capped score itself, clamped so that
// a masked entry gives 0. P and dS are rounded to bf16 before their
// products, as the forward rounds P; every sum is f32. At D = 128 the
// fragments of the held tiles are read from shared memory each k-step and
// pass (b) walks q tiles of 32 rows, so the f32 accumulators (dK and dV:
// 128 a lane) fit in registers.
//
// cuda_core (f32; bf16 at D = 160 and 256, where dK and dV of 16 keys
// would not fit in registers; bf16 whose rows are not 16-byte aligned): the
// first port's passes. 256 threads a block, each owning a
// (BT/16) x (BT/16) micro-tile of the score tile and (BT/16) rows x (D/16)
// columns of its accumulators, with the q, dO, K and V tiles converted to
// f32 in shared memory (rows padded by one float against bank conflicts).
// Tiles are 64 rows up to D = 160 (198 KB of shared memory a block there)
// and 32 at D = 256.
//
// Each kernel's shared-memory limit is raised once per device, at its first
// launch there, not at every launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// strides in elements: (batch, head, sequence) of each tensor
struct Strides {
  long long b, h, s;
};

struct BwdParams {
  int H, KH, Sq, Skv;
  Strides q, k, v, o, dout, dq, dk, dv;
  float sm_scale, softcap;
  int causal, window;
};

// rows of a q and of a kv tile: 64 up to D = 160, 32 at D = 256
template <int D> __host__ __device__ constexpr int tile_rows() { return D <= 160 ? 64 : 32; }

template <int D>
constexpr size_t smem_bytes() {
  constexpr int BT = tile_rows<D>();
  // q, dO, K, V tiles [BT][D+1]; P and dS tiles [BT][BT+1]; LSE and Di of the q tile
  return sizeof(float) * ((size_t)4 * BT * (D + 1) + (size_t)2 * BT * (BT + 1) + 2 * BT);
}

constexpr size_t kMaxSmem = 232448;
static_assert(smem_bytes<160>() <= kMaxSmem && smem_bytes<256>() <= kMaxSmem,
              "a head dimension's tiles do not fit in a block's shared memory");

// rows r0 .. r0 + BT of a [S, D] slice (row stride `stride`) into f32
// shared memory with rows of D + 1; rows past S are zero
template <typename T, int D, int BT>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, long long stride,
                                          int r0, int S) {
  for (int i = threadIdx.x; i < BT * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * (D + 1) + d] = r0 + r < S ? to_f32(src[(long long)(r0 + r) * stride + d]) : 0.f;
  }
}

// acc[r][c] = a row (ty + 16r) · b row (tx + 16c), over D
template <int D, int R>
__device__ __forceinline__ void tile_dot(float (&acc)[R][R], const float* a_s, const float* b_s,
                                         int ty, int tx) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[r][c] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[R], bv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) av[r] = a_s[(ty + 16 * r) * DP + d];
#pragma unroll
    for (int c = 0; c < R; ++c) bv[c] = b_s[(tx + 16 * c) * DP + d];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < R; ++c) acc[r][c] += av[r] * bv[c];
  }
}

// scores s = q·k and dp = dO·v of a (q tile at q0, kv tile at k0) pair, in
// place: s becomes P, dp becomes dS (both 0 where the key is hidden)
template <int R>
__device__ __forceinline__ void probs_and_grads(float (&s)[R][R], float (&dp)[R][R],
                                                const float* lse_s, const float* di_s, int q0,
                                                int k0, int ty, int tx, const BwdParams& pr) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qpos = q0 + ty + 16 * r;
    const float lse = lse_s[ty + 16 * r], di = di_s[ty + 16 * r];
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int kpos = k0 + tx + 16 * c;
      const bool ok = qpos < pr.Sq && kpos < pr.Skv && (!pr.causal || qpos >= kpos) &&
                      (pr.window <= 0 || qpos - kpos < pr.window) && lse > -INFINITY;
      float x = s[r][c] * pr.sm_scale, g = 1.f;
      if (pr.softcap > 0.f) {
        const float t = tanhf(x / pr.softcap);
        x = pr.softcap * t;
        g = 1.f - t * t;
      }
      const float p = ok ? expf(x - lse) : 0.f;
      s[r][c] = p;
      dp[r][c] = p * (dp[r][c] - di) * g;
    }
  }
}

// (a) Di = rowsum(dO ∘ O), one warp a row
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dot_kernel(const T* __restrict__ o,
                                                                const T* __restrict__ dout,
                                                                float* __restrict__ di, int D,
                                                                BwdParams pr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + warp;
  const int h = blockIdx.y, b = blockIdx.z;
  if (row >= pr.Sq) return;  // the whole warp
  const T* orow = o + b * pr.o.b + h * pr.o.h + (long long)row * pr.o.s;
  const T* drow = dout + b * pr.dout.b + h * pr.dout.h + (long long)row * pr.dout.s;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum += to_f32(orow[d]) * to_f32(drow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) di[((long long)b * pr.H + h) * pr.Sq + row] = sum;
}

// (b) dK and dV of one kv tile of one kv head
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
    T* __restrict__ dk, T* __restrict__ dv, BwdParams pr) {
  constexpr int BT = tile_rows<D>();
  constexpr int DP = D + 1, PP = BT + 1, R = BT / 16, DC = D / 16;
  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = pr.H / pr.KH;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BT * DP;
  float* q_s = v_s + BT * DP;
  float* do_s = q_s + BT * DP;
  float* p_s = do_s + BT * DP;
  float* ds_s = p_s + BT * PP;
  float* lse_s = ds_s + BT * PP;
  float* di_s = lse_s + BT;

  const int k0 = kt * BT;
  load_tile<T, D, BT>(k_s, k + b * pr.k.b + kh * pr.k.h, pr.k.s, k0, pr.Skv);
  load_tile<T, D, BT>(v_s, v + b * pr.v.b + kh * pr.v.h, pr.v.s, k0, pr.Skv);

  // the query rows that can see a key of this tile
  const int q_begin = pr.causal ? k0 : 0;
  int q_end = pr.Sq;
  if (pr.window > 0) q_end = min(q_end, min(pr.Skv, k0 + BT) - 1 + pr.window);

  float dk_acc[R][DC], dv_acc[R][DC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  for (int h = kh * G; h < (kh + 1) * G; ++h) {
    const T* qb = q + b * pr.q.b + h * pr.q.h;
    const T* dob = dout + b * pr.dout.b + h * pr.dout.h;
    const float* lse_h = lse + ((long long)b * pr.H + h) * pr.Sq;
    const float* di_h = di + ((long long)b * pr.H + h) * pr.Sq;
    for (int q0 = (q_begin / BT) * BT; q0 < q_end; q0 += BT) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D, BT>(q_s, qb, pr.q.s, q0, pr.Sq);
      load_tile<T, D, BT>(do_s, dob, pr.dout.s, q0, pr.Sq);
      if (tid < BT) {
        const bool in = q0 + tid < pr.Sq;
        lse_s[tid] = in ? lse_h[q0 + tid] : -INFINITY;
        di_s[tid] = in ? di_h[q0 + tid] : 0.f;
      }
      __syncthreads();

      float s[R][R], dp[R][R];
      tile_dot<D, R>(s, q_s, k_s, ty, tx);
      tile_dot<D, R>(dp, do_s, v_s, ty, tx);
      probs_and_grads<R>(s, dp, lse_s, di_s, q0, k0, ty, tx, pr);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) {
          p_s[(ty + 16 * r) * PP + tx + 16 * c] = s[r][c];
          ds_s[(ty + 16 * r) * PP + tx + 16 * c] = dp[r][c];
        }
      __syncthreads();

      // dV[j] += Σ_i P[i][j] dO[i];  dK[j] += Σ_i dS[i][j] Q[i]
#pragma unroll 4
      for (int i = 0; i < BT; ++i) {
        float pv[R], dsv[R], dov[DC], qv[DC];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          pv[r] = p_s[i * PP + ty + 16 * r];
          dsv[r] = ds_s[i * PP + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dov[c] = do_s[i * DP + tx + 16 * c];
          qv[c] = q_s[i * DP + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int c = 0; c < DC; ++c) {
            dv_acc[r][c] += pv[r] * dov[c];
            dk_acc[r][c] += dsv[r] * qv[c];
          }
      }
    }
  }

  T* dkb = dk + b * pr.dk.b + kh * pr.dk.h;
  T* dvb = dv + b * pr.dv.b + kh * pr.dv.h;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = k0 + ty + 16 * r;
    if (j >= pr.Skv) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dkb[(long long)j * pr.dk.s + tx + 16 * c] = from_f32<T>(dk_acc[r][c] * pr.sm_scale);
      dvb[(long long)j * pr.dv.s + tx + 16 * c] = from_f32<T>(dv_acc[r][c]);
    }
  }
}

// (c) dQ of one q tile of one query head
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
    T* __restrict__ dq, BwdParams pr) {
  constexpr int BT = tile_rows<D>();
  constexpr int DP = D + 1, PP = BT + 1, R = BT / 16, DC = D / 16;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (pr.H / pr.KH);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BT * DP;
  float* q_s = v_s + BT * DP;
  float* do_s = q_s + BT * DP;
  float* ds_s = do_s + BT * DP + BT * PP;  // the layout of pass (b); its P tile unused
  float* lse_s = ds_s + BT * PP;
  float* di_s = lse_s + BT;

  const int q0 = qt * BT;
  load_tile<T, D, BT>(q_s, q + b * pr.q.b + h * pr.q.h, pr.q.s, q0, pr.Sq);
  load_tile<T, D, BT>(do_s, dout + b * pr.dout.b + h * pr.dout.h, pr.dout.s, q0, pr.Sq);
  if (tid < BT) {
    const bool in = q0 + tid < pr.Sq;
    const long long at = ((long long)b * pr.H + h) * pr.Sq + q0 + tid;
    lse_s[tid] = in ? lse[at] : -INFINITY;
    di_s[tid] = in ? di[at] : 0.f;
  }

  // the kv positions any row of this tile can see
  const int q_last = min(pr.Sq, q0 + BT) - 1;
  int kv_end = pr.Skv;
  if (pr.causal) kv_end = min(kv_end, q_last + 1);
  const int kv_begin = pr.window > 0 ? max(0, q0 - pr.window + 1) : 0;
  const T* kb = k + b * pr.k.b + kh * pr.k.h;
  const T* vb = v + b * pr.v.b + kh * pr.v.h;

  float dq_acc[R][DC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq_acc[r][c] = 0.f;

  for (int k0 = (kv_begin / BT) * BT; k0 < kv_end; k0 += BT) {
    __syncthreads();  // q tile written; the previous kv tile's readers are done
    load_tile<T, D, BT>(k_s, kb, pr.k.s, k0, pr.Skv);
    load_tile<T, D, BT>(v_s, vb, pr.v.s, k0, pr.Skv);
    __syncthreads();

    float s[R][R], dp[R][R];
    tile_dot<D, R>(s, q_s, k_s, ty, tx);
    tile_dot<D, R>(dp, do_s, v_s, ty, tx);
    probs_and_grads<R>(s, dp, lse_s, di_s, q0, k0, ty, tx, pr);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int c = 0; c < R; ++c) ds_s[(ty + 16 * r) * PP + tx + 16 * c] = dp[r][c];
    __syncthreads();

    // dQ[i] += Σ_j dS[i][j] K[j]
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      float dsv[R], kv[DC];
#pragma unroll
      for (int r = 0; r < R; ++r) dsv[r] = ds_s[(ty + 16 * r) * PP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = k_s[j * DP + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) dq_acc[r][c] += dsv[r] * kv[c];
    }
  }

  T* dqb = dq + b * pr.dq.b + h * pr.dq.h;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = q0 + ty + 16 * r;
    if (i >= pr.Sq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dqb[(long long)i * pr.dq.s + tx + 16 * c] = from_f32<T>(dq_acc[r][c] * pr.sm_scale);
  }
}

// ------------------------------------------------------------ bf16: tensor cores
using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaRows = 16 * kMmaWarps;  // keys of a pass-(b) block; queries of a pass-(c) one
constexpr int kMmaKv = 64;                // keys of a pass-(c) kv tile
constexpr int kStages = 2;                // shared stages of each ring
constexpr float kLog2e = 1.4426950408889634f;

// query rows of a pass-(b) q tile: 64, or 32 at D = 128 (registers)
template <int D> __host__ __device__ constexpr int dkdv_q_rows() { return D <= 64 ? 64 : 32; }
// the held tiles' A fragments in registers (up to D = 64), else read from
// shared memory at each k-step
template <int D> __host__ __device__ constexpr bool frags_in_regs() { return D <= 64; }

template <int D>
constexpr size_t dkdv_mma_smem() {
  // K and V, then the ring's Q and dO tiles (rows padded by 8 elements),
  // then its LSE and Di
  constexpr int BQ = dkdv_q_rows<D>();
  return sizeof(bf16) * (size_t)(2 * kMmaRows + 2 * kStages * BQ) * (D + 8) +
         sizeof(float) * 2 * kStages * BQ;
}
template <int D>
constexpr size_t dq_mma_smem() {
  // Q and dO, then the ring's K and V tiles
  return sizeof(bf16) * (size_t)(2 * kMmaRows + 2 * kStages * kMmaKv) * (D + 8);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}
// 4 bytes global -> shared; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N of this thread's newest copy groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// c += a · b, m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// tanh without branches: 1 - 2/(e^{2x} + 1), x clamped to |x| <= 15 where
// tanh is +-1 in f32; absolute error ~1e-6
__device__ __forceinline__ float fast_tanh(float x) {
  x = fminf(fmaxf(x, -15.f), 15.f);
  return 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
// the A fragment of 16 rows x 16 columns (a k-step) from a padded shared
// tile, this lane's address of k-step 0 given (`frag_addr`)
template <int RW>
__device__ __forceinline__ const bf16* frag_addr(const bf16* tile, int row0, int lane) {
  return tile + (row0 + (lane & 15)) * RW + (lane >> 4) * 8;
}
// B fragments of two 8-row n-tiles (rows np*16 .. +16 of a [n][k] tile) at
// k-step ks: bf[0], bf[1] for the first, bf[2], bf[3] for the second
template <int RW>
__device__ __forceinline__ void load_b(uint32_t (&bf)[4], const bf16* tile, int np, int ks,
                                       int lane) {
  ldmatrix_x4(bf, tile + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * RW + ks * 16 +
                      ((lane >> 3) & 1) * 8);
}
// the same from a [k][n] tile (k-step kk over its rows, n-tiles dp*16 ..)
template <int RW>
__device__ __forceinline__ void load_b_trans(uint32_t (&bf)[4], const bf16* tile, int kk, int dp,
                                             int lane) {
  ldmatrix_x4_trans(bf, tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RW + dp * 16 +
                            (lane >> 4) * 8);
}
// scores in place, to base 2: scale, or the softcap cap·tanh(s·scale/cap)
template <int NT>
__device__ __forceinline__ void scale_scores(float (&s)[NT][4], const BwdParams& pr) {
  if (pr.softcap > 0.f) {
    const float in = pr.sm_scale / pr.softcap, out2 = pr.softcap * kLog2e;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = out2 * fast_tanh(s[t][e] * in);
  } else {
    const float scale2 = pr.sm_scale * kLog2e;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] *= scale2;
  }
}
// P and dS of one element from its base-2 score x (-inf where masked), the
// row's LSE·log2(e) and Di, and dP; `tinv` is 1/(cap·log2(e)) with a
// softcap, else 0, so that th is tanh of the capped score (−1 where masked)
__device__ __forceinline__ void prob_and_grad(float& s, float& dp, float lse2, float di,
                                              float tinv) {
  const float p = exp2f(s - lse2);
  const float th = fminf(fmaxf(s * tinv, -1.f), 1.f);
  dp = p * (dp - di) * (1.f - th * th);
  s = p;
}
// LSE (natural log) to the base-2 units of the scores; a row that sees no
// key (-inf) becomes +inf, so its probabilities come out 0
__device__ __forceinline__ float lse_base2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * kLog2e;
}
// the accumulators of two 8-column tiles as one 16-deep bf16 A fragment
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}
// 16 rows of an accumulator, times `scale`, to bf16 rows (row0 + lane/4 and
// + 8 of a [S, D] slice with row stride `stride`; rows at or past S skipped)
template <int DT>
__device__ __forceinline__ void store_rows(bf16* __restrict__ base, long long stride,
                                           const float (&acc)[DT][4], int row0, int S,
                                           float scale, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    if (row >= S) continue;
    bf16* dst = base + (long long)row * stride + (lane & 3) * 2;
#pragma unroll
    for (int t = 0; t < DT; ++t)
      *reinterpret_cast<__nv_bfloat162*>(dst + t * 8) =
          __floats2bfloat162_rn(acc[t][2 * r] * scale, acc[t][2 * r + 1] * scale);
  }
}

// (b) dK and dV of one kv tile of 64 keys of one kv head, on tensor cores
template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
    bf16* __restrict__ dk, bf16* __restrict__ dv, BwdParams pr) {
  constexpr int RW = D + 8;   // padded shared row, elements
  constexpr int CH = D / 8;   // 16-byte chunks a row
  constexpr int KS = D / 16;  // k-steps of Sᵀ and dPᵀ
  constexpr int DT = D / 8;   // 8-column tiles of dK and dV
  constexpr int BQ = dkdv_q_rows<D>();
  constexpr int NT = BQ / 8;  // 8-query tiles of Sᵀ
  constexpr bool FR = frags_in_regs<D>();
  const int kh = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;  // kv tiles slowest: first first
  const int G = pr.H / pr.KH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);        // [kMmaRows][RW]
  bf16* v_s = k_s + kMmaRows * RW;                      // [kMmaRows][RW]
  bf16* q_ring = v_s + kMmaRows * RW;                   // [kStages][BQ][RW]
  bf16* do_ring = q_ring + kStages * BQ * RW;           // [kStages][BQ][RW]
  float* lse_ring = reinterpret_cast<float*>(do_ring + kStages * BQ * RW);  // [kStages][BQ]
  float* di_ring = lse_ring + kStages * BQ;                                 // [kStages][BQ]

  const int k0 = kt * kMmaRows;
  const int k_last = min(pr.Skv, k0 + kMmaRows) - 1;
  const bf16* kb = k + b * pr.k.b + kh * pr.k.h;
  const bf16* vb = v + b * pr.v.b + kh * pr.v.h;
  for (int i = tid; i < kMmaRows * CH; i += kMmaThreads) {
    const int r = i / CH, x = (i - r * CH) * 8;
    const bool ok = k0 + r < pr.Skv;
    cp_async16(k_s + r * RW + x, ok ? kb + (long long)(k0 + r) * pr.k.s + x : kb, ok);
    cp_async16(v_s + r * RW + x, ok ? vb + (long long)(k0 + r) * pr.v.s + x : vb, ok);
  }
  cp_async_commit();

  // the q tiles whose rows can see a key of this tile, for each query head
  // of the group: one flat list of (head, q tile) pairs
  const int q_begin = pr.causal ? k0 : 0;
  const int q_end = pr.window > 0 ? min(pr.Sq, k_last + pr.window) : pr.Sq;
  const int qt0 = q_begin / BQ;
  const int n_qt = q_end > q_begin ? (q_end + BQ - 1) / BQ - qt0 : 0;
  const int items = G * n_qt;
  auto load_item = [&](int item, int st) {
    const int h = kh * G + item / n_qt;
    const int q0 = (qt0 + item % n_qt) * BQ;
    const bf16* qb = q + b * pr.q.b + h * pr.q.h;
    const bf16* dob = dout + b * pr.dout.b + h * pr.dout.h;
    bf16* qd = q_ring + st * BQ * RW;
    bf16* dd = do_ring + st * BQ * RW;
    for (int i = tid; i < BQ * CH; i += kMmaThreads) {
      const int r = i / CH, x = (i - r * CH) * 8;
      const bool ok = q0 + r < pr.Sq;
      cp_async16(qd + r * RW + x, ok ? qb + (long long)(q0 + r) * pr.q.s + x : qb, ok);
      cp_async16(dd + r * RW + x, ok ? dob + (long long)(q0 + r) * pr.dout.s + x : dob, ok);
    }
    const long long row = ((long long)b * pr.H + h) * pr.Sq + q0;
    for (int r = tid; r < BQ; r += kMmaThreads) {
      const bool ok = q0 + r < pr.Sq;
      cp_async4(lse_ring + st * BQ + r, ok ? lse + row + r : lse, ok);
      cp_async4(di_ring + st * BQ + r, ok ? di + row + r : di, ok);
    }
  };
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < items) load_item(st, st);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // K and V have landed (this thread's copies)
  __syncthreads();               // ... everyone's

  const bf16* k_frag = frag_addr<RW>(k_s, warp * 16, lane);
  const bf16* v_frag = frag_addr<RW>(v_s, warp * 16, lane);
  uint32_t kf[FR ? KS : 1][4], vf[FR ? KS : 1][4];
  if constexpr (FR) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldmatrix_x4(kf[ks], k_frag + ks * 16);
      ldmatrix_x4(vf[ks], v_frag + ks * 16);
    }
  }

  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[t][e] = dv_acc[t][e] = 0.f;
  // this lane's two keys (rows g and g + 8 of the warp's 16)
  const int kpos0 = k0 + warp * 16 + (lane >> 2);
  const float tinv = pr.softcap > 0.f ? 1.f / (pr.softcap * kLog2e) : 0.f;

  for (int item = 0; item < items; ++item) {
    const int st = item % kStages;
    cp_async_wait<kStages - 2>();  // this item's copies (this thread's)
    __syncthreads();               // ... everyone's; and the last item's stage is free
    if (item + kStages - 1 < items) load_item(item + kStages - 1, (item + kStages - 1) % kStages);
    cp_async_commit();
    const int q0 = (qt0 + item % n_qt) * BQ;
    const bf16* q_t = q_ring + st * BQ * RW;
    const bf16* do_t = do_ring + st * BQ * RW;
    const float* lse_t = lse_ring + st * BQ;
    const float* di_t = di_ring + st * BQ;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: this warp's 16 keys x BQ queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ka[4], va[4];
      if constexpr (FR) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ka[e] = kf[ks][e];
          va[e] = vf[ks][e];
        }
      } else {
        ldmatrix_x4(ka, k_frag + ks * 16);
        ldmatrix_x4(va, v_frag + ks * 16);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        load_b<RW>(bf, q_t, np, ks, lane);
        mma_bf16(s[2 * np], ka, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], ka, bf[2], bf[3]);
        load_b<RW>(bf, do_t, np, ks, lane);
        mma_bf16(dp[2 * np], va, bf[0], bf[1]);
        mma_bf16(dp[2 * np + 1], va, bf[2], bf[3]);
      }
    }

    scale_scores<NT>(s, pr);
    // the mask, on tiles that hold a masked entry: key row r sees queries
    // [lo, hi)
    const bool full = q0 + BQ <= pr.Sq && k0 + kMmaRows <= pr.Skv &&
                      (!pr.causal || q0 >= k0 + kMmaRows - 1) &&
                      (pr.window <= 0 || q0 + BQ - 1 - k0 < pr.window);
    if (!full) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kpos = kpos0 + 8 * r;
        const int lo = pr.causal ? kpos : 0;
        const int hi = kpos >= pr.Skv ? 0 : pr.window > 0 ? min(pr.Sq, kpos + pr.window) : pr.Sq;
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int qpos = q0 + t * 8 + (lane & 3) * 2 + c;
            s[t][2 * r + c] = qpos >= lo && qpos < hi ? s[t][2 * r + c] : -INFINITY;
          }
      }
    }
    // Pᵀ and dSᵀ; the columns are queries, so LSE and Di come per column
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int col = t * 8 + (lane & 3) * 2;
      const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
      const float2 d2 = *reinterpret_cast<const float2*>(di_t + col);
      const float lse2[2] = {lse_base2(l2.x), lse_base2(l2.y)};
      const float dis[2] = {d2.x, d2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) prob_and_grad(s[t][e], dp[t][e], lse2[e & 1], dis[e & 1], tinv);
    }

    // dV += Pᵀ·dO and dK += dSᵀ·Q, Pᵀ and dSᵀ rounded to bf16 straight from
    // the accumulators
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], da[4];
      pack_a(pa, s[2 * kk], s[2 * kk + 1]);
      pack_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dpi = 0; dpi < DT / 2; ++dpi) {
        uint32_t bf[4];
        load_b_trans<RW>(bf, do_t, kk, dpi, lane);
        mma_bf16(dv_acc[2 * dpi], pa, bf[0], bf[1]);
        mma_bf16(dv_acc[2 * dpi + 1], pa, bf[2], bf[3]);
        load_b_trans<RW>(bf, q_t, kk, dpi, lane);
        mma_bf16(dk_acc[2 * dpi], da, bf[0], bf[1]);
        mma_bf16(dk_acc[2 * dpi + 1], da, bf[2], bf[3]);
      }
    }
  }

  store_rows<DT>(dk + b * pr.dk.b + kh * pr.dk.h, pr.dk.s, dk_acc, k0 + warp * 16, pr.Skv,
                 pr.sm_scale, lane);
  store_rows<DT>(dv + b * pr.dv.b + kh * pr.dv.h, pr.dv.s, dv_acc, k0 + warp * 16, pr.Skv, 1.f,
                 lane);
}

// (c) dQ of one q tile of 64 rows of one query head, on tensor cores
template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ di,
    bf16* __restrict__ dq, BwdParams pr) {
  constexpr int RW = D + 8, CH = D / 8, KS = D / 16, DT = D / 8;
  constexpr int NT = kMmaKv / 8;  // 8-key tiles of S
  constexpr bool FR = frags_in_regs<D>();
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // the longest causal rows first
  const int kh = h / (pr.H / pr.KH);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kMmaRows][RW]
  bf16* do_s = q_s + kMmaRows * RW;               // [kMmaRows][RW]
  bf16* k_ring = do_s + kMmaRows * RW;            // [kStages][kMmaKv][RW]
  bf16* v_ring = k_ring + kStages * kMmaKv * RW;  // [kStages][kMmaKv][RW]

  const int q0 = qt * kMmaRows;
  const bf16* qb = q + b * pr.q.b + h * pr.q.h;
  const bf16* dob = dout + b * pr.dout.b + h * pr.dout.h;
  for (int i = tid; i < kMmaRows * CH; i += kMmaThreads) {
    const int r = i / CH, x = (i - r * CH) * 8;
    const bool ok = q0 + r < pr.Sq;
    cp_async16(q_s + r * RW + x, ok ? qb + (long long)(q0 + r) * pr.q.s + x : qb, ok);
    cp_async16(do_s + r * RW + x, ok ? dob + (long long)(q0 + r) * pr.dout.s + x : dob, ok);
  }
  cp_async_commit();

  // the kv tiles any row of this tile can see
  const int q_last = min(pr.Sq, q0 + kMmaRows) - 1;
  const int kv_end = pr.causal ? min(pr.Skv, q_last + 1) : pr.Skv;
  const int kt0 = (pr.window > 0 ? max(0, q0 - pr.window + 1) : 0) / kMmaKv;
  const int n_kt = kv_end > kt0 * kMmaKv ? (kv_end + kMmaKv - 1) / kMmaKv - kt0 : 0;
  const bf16* kb = k + b * pr.k.b + kh * pr.k.h;
  const bf16* vb = v + b * pr.v.b + kh * pr.v.h;
  auto load_kv = [&](int j, int st) {
    const int k0 = (kt0 + j) * kMmaKv;
    bf16* kd = k_ring + st * kMmaKv * RW;
    bf16* vd = v_ring + st * kMmaKv * RW;
    for (int i = tid; i < kMmaKv * CH; i += kMmaThreads) {
      const int r = i / CH, x = (i - r * CH) * 8;
      const bool ok = k0 + r < pr.Skv;
      cp_async16(kd + r * RW + x, ok ? kb + (long long)(k0 + r) * pr.k.s + x : kb, ok);
      cp_async16(vd + r * RW + x, ok ? vb + (long long)(k0 + r) * pr.v.s + x : vb, ok);
    }
  };
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_kt) load_kv(st, st);
    cp_async_commit();
  }
  cp_async_wait<kStages - 1>();  // Q and dO have landed (this thread's copies)
  __syncthreads();               // ... everyone's

  const bf16* q_frag = frag_addr<RW>(q_s, warp * 16, lane);
  const bf16* do_frag = frag_addr<RW>(do_s, warp * 16, lane);
  uint32_t qf[FR ? KS : 1][4], df[FR ? KS : 1][4];
  if constexpr (FR) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      ldmatrix_x4(qf[ks], q_frag + ks * 16);
      ldmatrix_x4(df[ks], do_frag + ks * 16);
    }
  }

  // this lane's two rows (g and g + 8 of the warp's 16): LSE, Di, bounds
  const int qpos0 = q0 + warp * 16 + (lane >> 2);
  float lse2[2], dis[2];
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qpos0 + 8 * r;
    const bool in = qpos < pr.Sq;
    const long long at = ((long long)b * pr.H + h) * pr.Sq + qpos;
    lse2[r] = in ? lse_base2(lse[at]) : INFINITY;
    dis[r] = in ? di[at] : 0.f;
    lo[r] = pr.window > 0 ? qpos - pr.window + 1 : 0;
    hi[r] = !in ? 0 : pr.causal ? min(pr.Skv, qpos + 1) : pr.Skv;
  }
  const float tinv = pr.softcap > 0.f ? 1.f / (pr.softcap * kLog2e) : 0.f;

  float dq_acc[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[t][e] = 0.f;

  for (int j = 0; j < n_kt; ++j) {
    const int st = j % kStages;
    cp_async_wait<kStages - 2>();  // this tile's copies (this thread's)
    __syncthreads();               // ... everyone's; and the last tile's stage is free
    if (j + kStages - 1 < n_kt) load_kv(j + kStages - 1, (j + kStages - 1) % kStages);
    cp_async_commit();
    const int k0 = (kt0 + j) * kMmaKv;
    const bf16* k_t = k_ring + st * kMmaKv * RW;
    const bf16* v_t = v_ring + st * kMmaKv * RW;

    // S = Q·Kᵀ and dP = dO·Vᵀ: this warp's 16 rows x 64 keys
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = dp[t][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], da[4];
      if constexpr (FR) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qa[e] = qf[ks][e];
          da[e] = df[ks][e];
        }
      } else {
        ldmatrix_x4(qa, q_frag + ks * 16);
        ldmatrix_x4(da, do_frag + ks * 16);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        load_b<RW>(bf, k_t, np, ks, lane);
        mma_bf16(s[2 * np], qa, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qa, bf[2], bf[3]);
        load_b<RW>(bf, v_t, np, ks, lane);
        mma_bf16(dp[2 * np], da, bf[0], bf[1]);
        mma_bf16(dp[2 * np + 1], da, bf[2], bf[3]);
      }
    }

    scale_scores<NT>(s, pr);
    const bool full = k0 + kMmaKv <= pr.Skv && q0 + kMmaRows <= pr.Sq &&
                      (!pr.causal || k0 + kMmaKv - 1 <= q0) &&
                      (pr.window <= 0 || q_last - k0 < pr.window);
    if (!full) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kpos = k0 + t * 8 + (lane & 3) * 2 + c;
            s[t][2 * r + c] = kpos >= lo[r] && kpos < hi[r] ? s[t][2 * r + c] : -INFINITY;
          }
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) prob_and_grad(s[t][e], dp[t][e], lse2[e >> 1], dis[e >> 1], tinv);

    // dQ += dS·K, dS rounded to bf16 straight from the accumulators
#pragma unroll
    for (int kk = 0; kk < kMmaKv / 16; ++kk) {
      uint32_t da[4];
      pack_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dpi = 0; dpi < DT / 2; ++dpi) {
        uint32_t bf[4];
        load_b_trans<RW>(bf, k_t, kk, dpi, lane);
        mma_bf16(dq_acc[2 * dpi], da, bf[0], bf[1]);
        mma_bf16(dq_acc[2 * dpi + 1], da, bf[2], bf[3]);
      }
    }
  }

  store_rows<DT>(dq + b * pr.dq.b + h * pr.dq.h, pr.dq.s, dq_acc, q0 + warp * 16, pr.Sq,
                 pr.sm_scale, lane);
}

// Raise a kernel's dynamic shared-memory limit once on each device (the
// attribute belongs to the kernel on the current device); `done` is the
// instantiation's own mask of devices.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (__atomic_load_n(&done, __ATOMIC_ACQUIRE) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) __atomic_fetch_or(&done, bit, __ATOMIC_RELEASE);
  return err;
}

template <typename T>
cudaError_t launch_dot(const void* o, const void* dout, float* di, int B, int D,
                       const BwdParams& pr, cudaStream_t stream) {
  flash_bwd_dot_kernel<T><<<dim3((pr.Sq + kThreads / 32 - 1) / (kThreads / 32), pr.H, B),
                            kThreads, 0, stream>>>(static_cast<const T*>(o),
                                                   static_cast<const T*>(dout), di, D, pr);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* di, void* dq, void* dk,
                       void* dv, int B, const BwdParams& pr, cudaStream_t stream) {
  static unsigned dkdv_done = 0, dq_done = 0;
  auto dkdv = flash_bwd_dkdv_mma_kernel<D>;
  auto dqk = flash_bwd_dq_mma_kernel<D>;
  cudaError_t err = opt_in_smem(dkdv, dkdv_mma_smem<D>(), dkdv_done);
  if (err != cudaSuccess) return err;
  err = opt_in_smem(dqk, dq_mma_smem<D>(), dq_done);
  if (err != cudaSuccess) return err;
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  err = launch_dot<bf16>(o, dout, di, B, D, pr, stream);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3(pr.KH, B, (pr.Skv + kMmaRows - 1) / kMmaRows), kMmaThreads, dkdv_mma_smem<D>(),
         stream>>>(qt, kt, vt, dot, lse, di, static_cast<bf16*>(dk), static_cast<bf16*>(dv), pr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<dim3(pr.H, B, (pr.Sq + kMmaRows - 1) / kMmaRows), kMmaThreads, dq_mma_smem<D>(),
        stream>>>(qt, kt, vt, dot, lse, di, static_cast<bf16*>(dq), pr);
  return cudaGetLastError();
}

// cp.async needs every row start on a 16-byte boundary: the base pointers,
// and strides that are multiples of 8 bf16 elements
bool mma_aligned(std::initializer_list<const void*> ptrs, const BwdParams& pr) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  const Strides* st[] = {&pr.q, &pr.k, &pr.v, &pr.o, &pr.dout, &pr.dq, &pr.dk, &pr.dv};
  for (const Strides* s : st)
    if (s->b % 8 || s->h % 8 || s->s % 8) return false;
  return true;
}

cudaError_t dispatch_mma(int D, const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, float* di, void* dq, void* dk,
                         void* dv, int B, const BwdParams& pr, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_mma<32>(q, k, v, o, dout, lse, di, dq, dk, dv, B, pr, stream);
    case 64:
      return launch_mma<64>(q, k, v, o, dout, lse, di, dq, dk, dv, B, pr, stream);
    case 128:
      return launch_mma<128>(q, k, v, o, dout, lse, di, dq, dk, dv, B, pr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------ launch: CUDA cores
template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* di, void* dq, void* dk, void* dv, int B,
                   const BwdParams& pr, cudaStream_t stream) {
  constexpr int BT = tile_rows<D>();
  constexpr size_t smem = smem_bytes<D>();
  static unsigned dkdv_done = 0, dq_done = 0;
  auto dkdv = flash_bwd_dkdv_kernel<T, D>;
  auto dqk = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = opt_in_smem(dkdv, smem, dkdv_done);
  if (err != cudaSuccess) return err;
  err = opt_in_smem(dqk, smem, dq_done);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);

  err = launch_dot<T>(o, dout, di, B, D, pr, stream);
  if (err != cudaSuccess) return err;
  dkdv<<<dim3((pr.Skv + BT - 1) / BT, pr.KH, B), kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, di, static_cast<T*>(dk), static_cast<T*>(dv), pr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<dim3((pr.Sq + BT - 1) / BT, pr.H, B), kThreads, smem, stream>>>(
      qt, kt, vt, dot, lse, di, static_cast<T*>(dq), pr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* di, void* dq, void* dk,
                       void* dv, int B, const BwdParams& pr, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, di, dq, dk, dv, B, pr, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, di, dq, dk, dv, B, pr, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, di, dq, dk, dv, B, pr, stream);
    case 160:
      return launch<T, 160>(q, k, v, o, dout, lse, di, dq, dk, dv, B, pr, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, dout, lse, di, dq, dk, dv, B, pr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory a block of passes (b) and (c) needs at head dimension D on
// the CUDA-core route.
extern "C" size_t flash_attention_bwd_smem(int D) {
  switch (D) {
    case 32:
      return smem_bytes<32>();
    case 64:
      return smem_bytes<64>();
    case 128:
      return smem_bytes<128>();
    case 160:
      return smem_bytes<160>();
    case 256:
      return smem_bytes<256>();
    default:
      return 0;
  }
}

// The same on the tensor-core route, of pass (b) (pass = 0) or (c) (pass = 1).
extern "C" size_t flash_attention_bwd_mma_smem(int D, int pass) {
  switch (D) {
    case 32:
      return pass == 0 ? dkdv_mma_smem<32>() : dq_mma_smem<32>();
    case 64:
      return pass == 0 ? dkdv_mma_smem<64>() : dq_mma_smem<64>();
    case 128:
      return pass == 0 ? dkdv_mma_smem<128>() : dq_mma_smem<128>();
    default:
      return 0;
  }
}

// Plain C entry point, bound with ctypes. dtype codes: 0 float32, 1
// bfloat16; route codes: 0 CUDA cores, 1 tensor cores (bf16, D in {32, 64,
// 128} and 16-byte-aligned rows, else cudaErrorInvalidValue). lse: f32
// [B, H, Sq] from the forward; di: an f32 [B, H, Sq] workspace (pass (a)
// writes it). Strides in elements, (batch, head, sequence) for each of q,
// k, v, o, dout, dq, dk, dv; softcap <= 0 and window <= 0 mean none. Returns
// the first failing launch's error (or the error of raising the
// shared-memory limit).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* di, void* dq,
                                   void* dk, void* dv, int B, int H, int KH, int Sq, int Skv,
                                   int D, int dtype, int route, const long long* strides,
                                   float sm_scale, float softcap, int causal, int window,
                                   void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Sq <= 0 || Skv <= 0)
    return cudaErrorInvalidValue;
  BwdParams pr;
  pr.H = H;
  pr.KH = KH;
  pr.Sq = Sq;
  pr.Skv = Skv;
  Strides* st[] = {&pr.q, &pr.k, &pr.v, &pr.o, &pr.dout, &pr.dq, &pr.dk, &pr.dv};
  for (int i = 0; i < 8; ++i) *st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  pr.sm_scale = sm_scale;
  pr.softcap = softcap;
  pr.causal = causal;
  pr.window = window;
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(di);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1 || !mma_aligned({q, k, v, o, dout, dq, dk, dv}, pr))
      return cudaErrorInvalidValue;
    return dispatch_mma(D, q, k, v, o, dout, l, d, dq, dk, dv, B, pr, s);
  }
  if (route != 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return dispatch_d<float>(D, q, k, v, o, dout, l, d, dq, dk, dv, B, pr, s);
    case 1:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, o, dout, l, d, dq, dk, dv, B, pr, s);
    default:
      return cudaErrorInvalidValue;
  }
}
