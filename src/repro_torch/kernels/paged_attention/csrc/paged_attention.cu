// Paged decode attention for Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel `paged_attention`
// (src/repro/kernels/paged_attention/kernel.py, body `_kernel`), and computes
// what `paged_attention_decode_ref` in ../ref.py computes: one query token per
// sequence attends over a paged KV pool read through a block table, with the
// current token's K/V (`k_new`/`v_new`, position lengths[b]-1) read from its
// operands instead of the pool. Without `k_new` it is `paged_attention_ref`.
//
// Layouts (all contiguous):
//   q, out        [B, H, D]        f32 or bf16 (out in q's type)
//   k_new, v_new  [B, KH, D]       q's type, or null
//   k/v_pages     [N, T, KH, D]    f32, bf16 or int8; one layer's pool slice
//   block_tables  [B, P] int32;  lengths [B] int32
//   k/v_scales    [N] f32 per-page dequant scales (int8 pages only), indexed
//                 by the physical page id block_tables[b, p], not by p
// Variants: GQA/MQA/MHA (H = KH*G), logit softcap cap*tanh(s/cap), sliding
// window (only [length-window, length) visible; pages wholly below it are
// skipped). Positions >= lengths[b] are masked, so the padding of a block
// table (which may name another slot's live page) is never read. A row with
// length 0 reads nothing and writes zeros.
//
// What bounds it: bytes. At the serving path's shapes (B=3, H=KH=16, D=64,
// T=16, up to 24 pages a row) one page of one layer carries 16*16*64*2 B for
// K and V together = 64 KiB, so a call at full context reads 4.5 MiB, ~1.4 us
// at 3.35 TB/s, against ~1.6 MFLOP per row. At that batch the launch itself
// (a few us) is the practical bound.
//
// Design, simple and right first: one thread block per (KV head, batch row),
// so the G query heads of a KV head share each page tile. A loop over the
// row's visible pages takes the place of the TPU kernel's sequential page
// grid axis: each iteration stages one [T, D] K tile and V tile in shared
// memory (dequantized to f32; the tile of one head is strided by KH*D in the
// pool), computes the G x T scores in f32, applies softcap and the mask, and
// updates a running max, sum and accumulator (online softmax in f32). The
// output is written once. Split-K over pages, cp.async/TMA double buffering
// and more blocks than B*KH are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads) paged_attention_decode_kernel(
    const QT* __restrict__ q, const QT* __restrict__ k_new, const QT* __restrict__ v_new,
    const KT* __restrict__ k_pages, const KT* __restrict__ v_pages,
    const int32_t* __restrict__ block_tables, const int32_t* __restrict__ lengths,
    const float* __restrict__ k_scales, const float* __restrict__ v_scales,
    QT* __restrict__ out, int KH, int D, int T, int P, int G, float sm_scale,
    float softcap, int window) {
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int H = KH * G;
  const int KD = D + 1;  // padded row stride of the K tile: no bank conflicts

  extern __shared__ float smem[];
  float* q_s = smem;             // [G, D], pre-scaled by sm_scale
  float* acc_s = q_s + G * D;    // [G, D]
  float* k_s = acc_s + G * D;    // [T, D+1]
  float* v_s = k_s + T * KD;     // [T, D]
  float* p_s = v_s + T * D;      // [G, T]
  float* m_s = p_s + G * T;      // [G]
  float* l_s = m_s + G;          // [G]
  float* alpha_s = l_s + G;      // [G]

  const int length = lengths[b];
  const int lo = window > 0 ? max(0, length - window) : 0;
  const int n_pages = min(P, (length + T - 1) / T);
  const int new_pos = k_new != nullptr ? length - 1 : -1;

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    q_s[i] = to_f32(q[((size_t)b * H + kh * G + g) * D + d]) * sm_scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  for (int p = lo / T; p < n_pages; ++p) {
    const int page = block_tables[(size_t)b * P + p];
    const float ks = k_scales != nullptr ? k_scales[page] : 1.f;
    const float vs = v_scales != nullptr ? v_scales[page] : 1.f;
    for (int i = tid; i < T * D; i += kThreads) {
      const int t = i / D, d = i - t * D;
      float kv, vv;
      if (p * T + t == new_pos) {
        const size_t off = ((size_t)b * KH + kh) * D + d;
        kv = to_f32(k_new[off]);
        vv = to_f32(v_new[off]);
      } else {
        const size_t off = (((size_t)page * T + t) * KH + kh) * D + d;
        kv = to_f32(k_pages[off]) * ks;
        vv = to_f32(v_pages[off]) * vs;
      }
      k_s[t * KD + d] = kv;
      v_s[i] = vv;
    }
    __syncthreads();

    for (int i = tid; i < G * T; i += kThreads) {
      const int g = i / T, t = i - g * T;
      const int pos = p * T + t;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += q_s[g * D + d] * k_s[t * KD + d];
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      p_s[i] = (pos < length && pos >= lo) ? s : kNegInf;
    }
    __syncthreads();

    for (int g = tid; g < G; g += kThreads) {
      const float m_prev = m_s[g];
      float m_new = m_prev;
      for (int t = 0; t < T; ++t) m_new = fmaxf(m_new, p_s[g * T + t]);
      float sum = 0.f;
      for (int t = 0; t < T; ++t) {
        const float e = expf(p_s[g * T + t] - m_new);
        p_s[g * T + t] = e;
        sum += e;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[g] = l_s[g] * alpha + sum;
      m_s[g] = m_new;
      alpha_s[g] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i - g * D;
      float a = acc_s[i] * alpha_s[g];
      for (int t = 0; t < T; ++t) a += p_s[g * T + t] * v_s[t * D + d];
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    out[((size_t)b * H + kh * G + g) * D + d] =
        from_f32<QT>(acc_s[i] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename QT, typename KT>
cudaError_t launch(const void* q, const void* k_new, const void* v_new, const void* k_pages,
                   const void* v_pages, const void* block_tables, const void* lengths,
                   const void* k_scales, const void* v_scales, void* out, int B, int KH,
                   int D, int T, int P, int G, float sm_scale, float softcap, int window,
                   size_t smem, cudaStream_t stream) {
  const dim3 grid(KH, B);
  paged_attention_decode_kernel<QT, KT><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const QT*>(k_new),
      static_cast<const QT*>(v_new), static_cast<const KT*>(k_pages),
      static_cast<const KT*>(v_pages), static_cast<const int32_t*>(block_tables),
      static_cast<const int32_t*>(lengths), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<QT*>(out), KH, D, T, P, G, sm_scale,
      softcap, window);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* k_new, const void* v_new,
                        const void* k_pages, const void* v_pages, const void* block_tables,
                        const void* lengths, const void* k_scales, const void* v_scales,
                        void* out, int B, int KH, int D, int T, int P, int G,
                        float sm_scale, float softcap, int window, size_t smem,
                        cudaStream_t stream) {
  switch (kv_dtype) {
    case 0:
      return launch<QT, float>(q, k_new, v_new, k_pages, v_pages, block_tables, lengths,
                               k_scales, v_scales, out, B, KH, D, T, P, G, sm_scale, softcap,
                               window, smem, stream);
    case 1:
      return launch<QT, __nv_bfloat16>(q, k_new, v_new, k_pages, v_pages, block_tables,
                                       lengths, k_scales, v_scales, out, B, KH, D, T, P, G,
                                       sm_scale, softcap, window, smem, stream);
    case 2:
      return launch<QT, int8_t>(q, k_new, v_new, k_pages, v_pages, block_tables, lengths,
                                k_scales, v_scales, out, B, KH, D, T, P, G, sm_scale,
                                softcap, window, smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory the kernel needs for one block, in bytes.
extern "C" size_t paged_attention_decode_smem(int G, int D, int T) {
  return sizeof(float) * ((size_t)2 * G * D + (size_t)T * (D + 1) + (size_t)T * D +
                          (size_t)G * T + 3 * (size_t)G);
}

// Plain C entry point, bound with ctypes. dtype codes: 0 float32, 1 bfloat16,
// 2 int8 (pages only). softcap <= 0 and window <= 0 mean none. Returns the
// launch's cudaGetLastError().
extern "C" int paged_attention_decode(const void* q, const void* k_new, const void* v_new,
                                      const void* k_pages, const void* v_pages,
                                      const void* block_tables, const void* lengths,
                                      const void* k_scales, const void* v_scales, void* out,
                                      int B, int H, int KH, int D, int T, int P,
                                      int q_dtype, int kv_dtype, float sm_scale,
                                      float softcap, int window, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || D <= 0 || T <= 0 || P <= 0)
    return cudaErrorInvalidValue;
  const int G = H / KH;
  const size_t smem = paged_attention_decode_smem(G, D, T);
  if (smem > 48 * 1024) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0:
      return dispatch_kv<float>(kv_dtype, q, k_new, v_new, k_pages, v_pages, block_tables,
                                lengths, k_scales, v_scales, out, B, KH, D, T, P, G, sm_scale,
                                softcap, window, smem, s);
    case 1:
      return dispatch_kv<__nv_bfloat16>(kv_dtype, q, k_new, v_new, k_pages, v_pages,
                                        block_tables, lengths, k_scales, v_scales, out, B, KH,
                                        D, T, P, G, sm_scale, softcap, window, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}
