// Flash attention (sequence prefill) for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention/kernel.py, body `_kernel`), and computes
// what `flash_attention_ref` and `blockwise_attention` in ../ref.py compute:
// softmax(q kᵀ / sqrt(D)) v per (batch, head) with an online softmax in f32,
// causal or bidirectional, with a sliding window, a logit softcap
// cap·tanh(s/cap), GQA (query head h reads KV head h / (H/KH)) and a query
// offset (chunked prefill: query i sits at position q_offset + i). Beyond the
// Pallas kernel it takes ragged Sq and Skv (the tails are masked; there is
// no divisibility requirement), an optional per-row valid KV length
// `kv_lengths [B]` and a KV "hole" [hole_lo, hole_hi) masked for every query
// (the padding between a bucketed prefix's real and padded length).
// Probabilities are rounded to the input type before the P·V product, as
// `blockwise_attention` does; the softmax denominator sums them unrounded.
//
// Layouts: one kernel for both entry points, selected by strides (in
// elements; the head dimension has stride 1):
//   flash_attention    q [B, H, Sq, D], k/v [B, KH, Skv, D], out like q
//   prefill_attention  q [B, Sq, H, D], k/v [B, Skv, KH, D], out like q
// D is 32, 64 or 128; the type is f32 or bf16 (out in q's type).
// A query row that sees no key at all (every key masked) is written as 0;
// the plain versions return the mean of v there, a row no serving path
// produces (a causal query always sees itself).
//
// What bounds it: bytes at the serving path's shapes. qwen1.5-0.5b's
// monolithic prefill at S = 384 (H = KH = 16, D = 64, bf16, causal) moves
// q, k, v and out once (3.1 MB, ~0.94 us at 3.35 TB/s) against 0.30 GFLOP
// of useful products (~0.3 us at the bf16 tensor-core peak). In practice a
// simple kernel is bound by its own issue rate: the products run on CUDA
// cores in f32.
//
// Design, simple and right first: one block of 256 threads per (q tile of
// 64 rows, head, batch row). A loop over kv tiles of 64 rows carries the
// online-softmax max, sum and output accumulator in registers, in place of
// the Pallas grid's sequential kv axis and its VMEM scratch. Each thread
// owns 4 query rows × 4 key columns of the score tile and 4 rows × D/16
// columns of the accumulator (a register micro-tile, so each shared-memory
// load feeds 4 multiply-adds); the row max and sum reduce across the 16
// lanes that share a row with warp shuffles. The q tile (pre-scaled) and the
// K tile sit in shared memory as f32 with rows padded by one float against
// bank conflicts, and the probabilities go through a shared tile to the P·V
// product. Kv tiles that causality, the window, kv_lengths or the hole mask
// entirely are never loaded, as the Pallas `pl.when(live)` skips them.
// Tensor cores (wgmma on bf16 tiles), TMA loads and split-K are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 64;  // key rows per kv tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back (the probabilities' rounding before P·V)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

struct Params {
  int H, KH, Sq, Skv;
  long long q_b, q_h, q_s;  // strides of q (and of out, which is allocated like q)
  long long k_b, k_h, k_s;
  long long v_b, v_h, v_s;
  long long o_b, o_h, o_s;
  float sm_scale, softcap;
  int causal, window, q_offset, hole_lo, hole_hi;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int32_t* __restrict__ kv_lengths, T* __restrict__ out, Params pr) {
  constexpr int DP = D + 1;    // padded row stride of the q and K tiles
  constexpr int PP = kBK + 1;  // padded row stride of the probability tile
  constexpr int DC = D / 16;   // accumulator columns per thread
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (pr.H / pr.KH);
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // key columns tx + 16c; accumulator columns tx + 16c
  const int ty = tid / 16;  // query rows ty + 16r

  extern __shared__ float smem[];
  float* q_s = smem;            // [kBQ, D+1], pre-scaled
  float* k_s = q_s + kBQ * DP;  // [kBK, D+1]
  float* v_s = k_s + kBK * DP;  // [kBK, D]
  float* p_s = v_s + kBK * D;   // [kBQ, kBK+1]

  const int q0 = qt * kBQ;
  const T* qb = q + b * pr.q_b + h * pr.q_h;
  const T* kb = k + b * pr.k_b + kh * pr.k_h;
  const T* vb = v + b * pr.v_b + kh * pr.v_h;
  const int kv_len = kv_lengths != nullptr ? kv_lengths[b] : pr.Skv;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    q_s[r * DP + d] = q0 + r < pr.Sq ? to_f32(qb[(q0 + r) * pr.q_s + d]) * pr.sm_scale : 0.f;
  }

  // the kv positions any row of this tile can see
  const int q_first = pr.q_offset + q0;
  const int q_last = pr.q_offset + min(pr.Sq, q0 + kBQ) - 1;
  int kv_end = min(pr.Skv, kv_len);
  if (pr.causal) kv_end = min(kv_end, q_last + 1);
  const int kv_begin = pr.window > 0 ? max(0, q_first - pr.window + 1) : 0;

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = (kv_begin / kBK) * kBK; k0 < kv_end; k0 += kBK) {
    if (pr.hole_hi > pr.hole_lo && k0 >= pr.hole_lo && k0 + kBK <= pr.hole_hi) continue;
    __syncthreads();  // q_s written; k_s, v_s and p_s free
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      const int pos = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (pos < pr.Skv) {
        kv = to_f32(kb[pos * pr.k_s + d]);
        vv = to_f32(vb[pos * pr.v_s + d]);
      }
      k_s[r * DP + d] = kv;
      v_s[r * D + d] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = q_s[(ty + 16 * r) * DP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = k_s[(tx + 16 * c) * DP + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] += qv[r] * kv[c];
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = ty + 16 * r;
      const int qpos = pr.q_offset + q0 + row;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + tx + 16 * c;
        float sv = s[r][c];
        if (pr.softcap > 0.f) sv = pr.softcap * tanhf(sv / pr.softcap);
        ok[c] = kpos < pr.Skv && kpos < kv_len && (!pr.causal || qpos >= kpos) &&
                (pr.window <= 0 || qpos - kpos < pr.window) &&
                !(kpos >= pr.hole_lo && kpos < pr.hole_hi);
        s[r][c] = sv;
        if (ok[c]) mx = fmaxf(mx, sv);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[r][c] - m_new) : 0.f;
        sum += p;
        p_s[row * PP + tx + 16 * c] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[DC];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = p_s[(ty + 16 * r) * PP + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = v_s[j * D + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[r][c] += pv[r] * vv[c];
    }
  }

  T* ob = out + b * pr.o_b + h * pr.o_h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row >= pr.Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) ob[row * pr.o_s + tx + 16 * c] = from_f32<T>(acc[r][c] / denom);
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D +
                          (size_t)kBQ * (kBK + 1));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_lengths, void* out,
                   int B, const Params& pr, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((pr.Sq + kBQ - 1) / kBQ, pr.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(kv_lengths), static_cast<T*>(out), pr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* kv_lengths, void* out, int B, const Params& pr,
                       cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, kv_lengths, out, B, pr, stream);
    case 64:
      return launch<T, 64>(q, k, v, kv_lengths, out, B, pr, stream);
    case 128:
      return launch<T, 128>(q, k, v, kv_lengths, out, B, pr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory one block needs at head dimension D, in bytes.
extern "C" size_t flash_attention_smem(int D) { return smem_bytes(D); }

// Plain C entry point, bound with ctypes. dtype codes: 0 float32, 1 bfloat16.
// Strides in elements; kv_lengths may be null; softcap <= 0 and window <= 0
// mean none; hole_lo >= hole_hi means no hole. Returns the launch's
// cudaGetLastError() (or the error of setting the shared-memory limit).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* kv_lengths, void* out, int B, int H, int KH,
                                   int Sq, int Skv, int D, int dtype, long long q_b,
                                   long long q_h, long long q_s, long long k_b, long long k_h,
                                   long long k_s, long long v_b, long long v_h, long long v_s,
                                   long long o_b, long long o_h, long long o_s, float sm_scale,
                                   float softcap, int causal, int window, int q_offset,
                                   int hole_lo, int hole_hi, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Sq <= 0 || Skv <= 0)
    return cudaErrorInvalidValue;
  const Params pr{H,   KH,  Sq,  Skv,      q_b,     q_h,    q_s,    k_b,     k_h,     k_s,
                  v_b, v_h, v_s, o_b,      o_h,     o_s,    sm_scale, softcap, causal, window,
                  q_offset, hole_lo, hole_hi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch_d<float>(D, q, k, v, kv_lengths, out, B, pr, s);
    case 1:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, kv_lengths, out, B, pr, s);
    default:
      return cudaErrorInvalidValue;
  }
}
