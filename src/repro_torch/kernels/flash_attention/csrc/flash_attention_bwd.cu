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
// then retraces the same bits):
//   (a) Di = rowsum(dO ∘ O) in f32, one warp a row;
//   (b) one block for each (kv tile, kv head, batch row): K and V tiles stay
//       in shared memory while the block walks the q tiles that can see them
//       (causal and window bounds) for each query head of the group,
//       recomputing P and dS and accumulating dV and dK in registers;
//   (c) one block for each (q tile, head, batch row): Q and dO stay while
//       the block walks the visible kv tiles, accumulating dQ.
// Each pass writes each output element once.
//
// What bounds it: operations. At qwen1.5-0.5b's training shape (B = 4,
// S = 1024, 16x64, causal) the passes compute ~7 products of 2·D
// operations for every visible (query, key) pair, ~30 GFLOP, against 50 MB
// of operands. This first version is simple and runs on CUDA cores: 256
// threads a block, each owning a (BT/16) x (BT/16) micro-tile of the score
// tile and (BT/16) rows x (D/16) columns of its accumulators, with the
// q, dO, K and V tiles converted to f32 in shared memory (rows padded by
// one float against bank conflicts). Tiles are 64 rows up to D = 160
// (198 KB of shared memory a block there) and 32 at D = 256. A tensor-core
// (mma.sync) version is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* di, void* dq, void* dk, void* dv, int B,
                   const BwdParams& pr, cudaStream_t stream) {
  constexpr int BT = tile_rows<D>();
  constexpr size_t smem = smem_bytes<D>();
  auto dkdv = flash_bwd_dkdv_kernel<T, D>;
  auto dqk = flash_bwd_dq_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);

  flash_bwd_dot_kernel<T><<<dim3((pr.Sq + kThreads / 32 - 1) / (kThreads / 32), pr.H, B),
                            kThreads, 0, stream>>>(static_cast<const T*>(o), dot, di, D, pr);
  err = cudaGetLastError();
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

// Shared memory a block of passes (b) and (c) needs at head dimension D.
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

// Plain C entry point, bound with ctypes. dtype codes: 0 float32, 1
// bfloat16. lse: f32 [B, H, Sq] from the forward; di: an f32 [B, H, Sq]
// workspace (pass (a) writes it). Strides in elements, (batch, head,
// sequence) for each of q, k, v, o, dout, dq, dk, dv; softcap <= 0 and
// window <= 0 mean none. Returns the first failing launch's error (or the
// error of setting the shared-memory limit).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* di, void* dq,
                                   void* dk, void* dv, int B, int H, int KH, int Sq, int Skv,
                                   int D, int dtype, const long long* strides, float sm_scale,
                                   float softcap, int causal, int window, void* stream) {
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
  switch (dtype) {
    case 0:
      return dispatch_d<float>(D, q, k, v, o, dout, l, d, dq, dk, dv, B, pr, s);
    case 1:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, o, dout, l, d, dq, dk, dv, B, pr, s);
    default:
      return cudaErrorInvalidValue;
  }
}
