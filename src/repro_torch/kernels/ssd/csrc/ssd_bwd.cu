// Backward of the Mamba-2 SSD chunked scan for Hopper (sm_90a), CUDA C++.
//
// No TPU kernel to replace: the reference differentiates its plain jnp
// scan (`ssd_reference`, src/repro/models/layers.py) with
// `jax.value_and_grad`. This computes the same gradients as autograd
// through ../ref.py `ssd_reference`, for a single B/C group, from the
// forward's operands alone, so it does not depend on the route the forward
// took. ../ref.py `ssd_backward_passes_ref` is this decomposition in plain
// PyTorch.
//
// Per (row, head) and chunk of Q positions, with a = dt·A, cum its prefix
// sum in the chunk, T the chunk's total, u = dt·x, L_ij = exp(cum_i - cum_j)
// for j <= i, h_in the state before the chunk and dh_out the gradient of
// the state after it:
//   du_j  = Σ_{i>=j} (C_i·B_j) L_ij dy_i + exp(T - cum_j) dh_out B_j
//   dx_j  = dt_j du_j, and the direct part of ddt_j is x_j·du_j
//   dC_i  = Σ_{j<=i} L_ij (dy_i·u_j) B_j + exp(cum_i) h_inᵀ dy_i
//   dB_j  = Σ_{i>=j} L_ij (dy_i·u_j) C_i + exp(T - cum_j) dh_outᵀ u_j
//   dcum  = every exponent's share; da = its reverse prefix sum;
//           ddt += A·da, dA = Σ dt·da
//   dh_in = exp(T) dh_out + Σ_i exp(cum_i) dy_i ⊗ C_i   (reverse over chunks)
//
// Passes, all launched by the one C entry point below, deterministic (no
// atomics: every sum runs in a fixed order), products in f32 on CUDA cores
// from the operands as they come (bf16 or f32):
//   1. `ssd_bwd_chunk_kernel`, one block a (tile of 32 x 64 of the [P, N]
//      state, chunk, row, head, mode): cum (a warp scan, written to the
//      workspace) and either the chunk's own state Σ_j exp(T - cum_j) u_j ⊗
//      B_j (mode 0) or its share of dh, Σ_i exp(cum_i) dy_i ⊗ C_i (mode 1).
//   2. `ssd_bwd_state_kernel`, a thread per state element of a (row, head),
//      serial over chunks: in place, the state before each chunk, then in
//      reverse the gradient of the state after each chunk (the last one's
//      is the final state's cotangent, zero without one).
//   3. `ssd_bwd_grad_kernel`, one block a (row, chunk, head): two sweeps
//      over tiles of 32 rows. Sweep A holds a tile of queries i and walks
//      the key tiles j <= i: dC and the row sums of M_ij = (dy_i·u_j)
//      (C_i·B_j) L_ij. Sweep B holds a tile of keys j and walks the query
//      tiles i >= j: du, dB and the column sums of M. Both recompute the
//      32 x 32 tiles of C·Bᵀ and dy·uᵀ (the mask applied before the exp);
//      the state terms go through slices of 32 rows of h_in or dh_out
//      staged in shared memory. Then dcum, its reverse prefix sum (a warp
//      scan), ddt, dx, and the head's share of dA; dB and dC a head's own.
//   4. `ssd_bwd_reduce_kernel` sums dB and dC over the heads in order,
//      `ssd_bwd_reduce_da_kernel` dA over rows and chunks in order.
// Positions past S are the forward's zero padding (dt = x = B = C = 0, and
// dy = 0): they contribute nothing, and their gradients are not written.
//
// Layouts (the last dimension of every input has stride 1; the others are
// strides the wrapper passes, so slices of the model's fused projection
// need no copy):
//   x, dy  [B, S, H, P]  f32 or bf16 (dy in x's type)   dt [B, S, H] f32
//   Bm, Cm [B, S, N]     f32 or bf16                    A  [H] f32
//   dfinal [B, H, P, N]  f32, contiguous, or null
//   dx [B, S, H, P] in x's type, ddt [B, S, H] f32, dA [H] f32,
//   dB, dC [B, S, N] in B's type: all contiguous.
// The workspace (f32, ops._bwd_workspace_bytes): cum [B, C, H, Q], the
// states [B, C, H, P, N], their gradients [B, C, H, P, N], a head's dB and
// dC [B, S, H, N] each, a (row, chunk, head)'s dA [B, C, H].
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;            // chunk rows a tile (pass 3)
constexpr int kOutP = 32, kOutN = 64;  // state elements a pass-1 block
constexpr int kSmemLimit = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides {
  long long x_b, x_s, x_h;     // x   (p stride 1)
  long long dt_b, dt_s;        // dt  (h stride 1)
  long long b_b, b_s;          // Bm  (n stride 1)
  long long c_b, c_s;          // Cm  (n stride 1)
  long long dy_b, dy_s, dy_h;  // dy  (p stride 1)
};

struct Dims {
  int B, S, H, P, N, Q, C;  // C: chunks
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// cum_s[q] = dt_s[0] a + ... + dt_s[q] a over the chunk, by warp 0: each lane
// sums a run, then a shuffle scan adds the runs before it (the forward's
// order, ../csrc/ssd.cu chunk_cumsum)
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

// v_s[q] = v_s[q] + ... + v_s[Q-1] in place, by warp 0: the reverse of
// chunk_cumsum's scan
__device__ __forceinline__ void chunk_suffix_sum(float* v_s, int Q, int tid) {
  if (tid >= 32) return;
  const int per = (Q + 31) / 32;
  const int lo = min(Q, tid * per), hi = min(Q, lo + per);
  float run = 0.f;
  for (int q = hi - 1; q >= lo; --q) {
    run += v_s[q];
    v_s[q] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, incl, off);
    if (tid + off < 32) incl += v;
  }
  const float base = incl - run;
  for (int q = lo; q < hi; ++q) v_s[q] += base;
}

// Pass 1. blockIdx.x = tile + tiles * (mode + 2 * (b * C + c)), blockIdx.y = h.
template <typename XT, typename BT>
__global__ void __launch_bounds__(kThreads) ssd_bwd_chunk_kernel(
    const XT* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const BT* __restrict__ Bm, const BT* __restrict__ Cm, const XT* __restrict__ dy,
    float* __restrict__ cum_ws, float* __restrict__ states, float* __restrict__ dstates, Dims d,
    Strides st, int n_tiles) {
  const int tiles = ((d.P + kOutP - 1) / kOutP) * n_tiles;
  const int tile = blockIdx.x % tiles, rest = blockIdx.x / tiles;
  const int mode = rest & 1, bc = rest >> 1, b = bc / d.C, c = bc % d.C;
  const int h = blockIdx.y, tid = threadIdx.x;
  const int p0 = (tile / n_tiles) * kOutP, n0 = (tile % n_tiles) * kOutN;
  const int Q = d.Q, s0 = c * Q;

  extern __shared__ float smem[];
  float* cum_s = smem;            // [Q]
  float* w_s = cum_s + Q;         // [Q]: dt, then the rows' weights
  float* a_s = w_s + Q;           // [kTile][kOutP]
  float* b_s = a_s + kTile * kOutP;  // [kTile][kOutN]

  const float* dtb = dt + b * st.dt_b + h;
  for (int q = tid; q < Q; q += kThreads)
    w_s[q] = s0 + q < d.S ? dtb[(long long)(s0 + q) * st.dt_s] : 0.f;
  __syncthreads();
  chunk_cumsum(w_s, A[h], cum_s, Q, tid);
  __syncthreads();
  const float total = cum_s[Q - 1];
  if (mode == 0 && tile == 0) {
    float* cw = cum_ws + ((size_t)bc * d.H + h) * Q;
    for (int q = tid; q < Q; q += kThreads) cw[q] = cum_s[q];
  }
  __syncthreads();
  for (int q = tid; q < Q; q += kThreads)
    w_s[q] = mode == 0 ? w_s[q] * expf(total - cum_s[q]) : expf(cum_s[q]);

  const XT* src = mode == 0 ? x + b * st.x_b + h * st.x_h : dy + b * st.dy_b + h * st.dy_h;
  const long long src_s = mode == 0 ? st.x_s : st.dy_s;
  const BT* bsrc = mode == 0 ? Bm + b * st.b_b : Cm + b * st.c_b;
  const long long bsrc_s = mode == 0 ? st.b_s : st.c_s;
  const int tp = tid >> 3, tn = tid & 7;  // out[p0 + tp][n0 + tn + 8k], k < 8
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  for (int j0 = 0; j0 < Q; j0 += kTile) {
    __syncthreads();  // w_s written; the previous tile read
    for (int i = tid; i < kTile * kOutP; i += kThreads) {
      const int jj = i / kOutP, p = p0 + i % kOutP, q = j0 + jj;
      a_s[i] = q < Q && s0 + q < d.S && p < d.P
                   ? w_s[q] * to_f32(src[(long long)(s0 + q) * src_s + p])
                   : 0.f;
    }
    for (int i = tid; i < kTile * kOutN; i += kThreads) {
      const int jj = i / kOutN, n = n0 + i % kOutN, q = j0 + jj;
      b_s[i] = q < Q && s0 + q < d.S && n < d.N
                   ? to_f32(bsrc[(long long)(s0 + q) * bsrc_s + n])
                   : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < kTile; ++jj) {
      const float av = a_s[jj * kOutP + tp];
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] += av * b_s[jj * kOutN + tn + 8 * k];
    }
  }
  const int p = p0 + tp;
  if (p < d.P) {
    float* out = (mode == 0 ? states : dstates) + ((size_t)bc * d.H + h) * d.P * d.N;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int n = n0 + tn + 8 * k;
      if (n < d.N) out[(size_t)p * d.N + n] = acc[k];
    }
  }
}

// Pass 2, a thread per state element of a (row, head), serial over chunks:
// slot c of `states` becomes the state before chunk c, slot c of `dstates`
// the gradient of the state after chunk c.
__global__ void __launch_bounds__(kThreads) ssd_bwd_state_kernel(
    const float* __restrict__ cum_ws, float* __restrict__ states, float* __restrict__ dstates,
    const float* __restrict__ dfinal, Dims d) {
  const size_t PN = (size_t)d.P * d.N;
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  float carry = 0.f;
  for (int c = 0; c < d.C; ++c) {
    const size_t slot = ((size_t)b * d.C + c) * d.H + h;
    const float decay = expf(cum_ws[slot * d.Q + d.Q - 1]);
    float* s = states + slot * PN + e;
    const float v = *s;
    *s = carry;
    carry = carry * decay + v;
  }
  float dcarry = dfinal != nullptr ? dfinal[((size_t)b * d.H + h) * PN + e] : 0.f;
  for (int c = d.C - 1; c >= 0; --c) {
    const size_t slot = ((size_t)b * d.C + c) * d.H + h;
    const float decay = expf(cum_ws[slot * d.Q + d.Q - 1]);
    float* s = dstates + slot * PN + e;
    const float v = *s;
    *s = dcarry;
    dcarry = dcarry * decay + v;
  }
}

// Pass 3's shared memory, in floats: seven [Q] vectors, six tiles of 32
// rows (two [32][N+1] and two [32][P+1] operands, a [32][N+1] and a
// [32][P+1] accumulator), three [32][33] score tiles, kWarps partial sums.
__host__ __device__ inline size_t grad_smem_floats(int P, int N, int Q) {
  return 7 * (size_t)Q + 3 * (size_t)kTile * (N + 1) + 3 * (size_t)kTile * (P + 1) +
         3 * (size_t)kTile * (kTile + 1) + kWarps;
}

// The 32 x 32 score tiles of query rows i0 + r (ci_s: C, dyi_s: dy) against
// key rows j0 + jj (bj_s: B, uj_s: u = dt·x): w = (C·B) L, v = (dy·u) L,
// m = v (C·B), zero where the key comes after the query or past the chunk.
__device__ __forceinline__ void score_tiles(const float* ci_s, const float* dyi_s,
                                            const float* bj_s, const float* uj_s,
                                            const float* cum_s, int i0, int j0, int Q, int P,
                                            int N, float* w_s, float* v_s, float* m_s,
                                            int tid) {
  const int NP = N + 1, PP = P + 1, TP = kTile + 1;
  for (int e = tid; e < kTile * kTile; e += kThreads) {
    const int r = e >> 5, jj = e & 31;
    const int qi = i0 + r, qj = j0 + jj;
    float w = 0.f, v = 0.f, m = 0.f;
    if (qj <= qi && qi < Q) {
      float g = 0.f, dd = 0.f;
      for (int n = 0; n < N; ++n) g += ci_s[r * NP + n] * bj_s[jj * NP + n];
      for (int p = 0; p < P; ++p) dd += dyi_s[r * PP + p] * uj_s[jj * PP + p];
      const float l = expf(cum_s[qi] - cum_s[qj]);
      w = g * l;
      v = dd * l;
      m = v * g;
    }
    w_s[r * TP + jj] = w;
    v_s[r * TP + jj] = v;
    m_s[r * TP + jj] = m;
  }
}

// Pass 3, one block a (row x chunk, head).
template <typename XT, typename BT>
__global__ void __launch_bounds__(kThreads) ssd_bwd_grad_kernel(
    const XT* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const BT* __restrict__ Bm, const BT* __restrict__ Cm, const XT* __restrict__ dy,
    const float* __restrict__ cum_ws, const float* __restrict__ states,
    const float* __restrict__ dstates, int has_dfinal, XT* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ db_part, float* __restrict__ dc_part,
    float* __restrict__ da_part, Dims d, Strides st) {
  const int bc = blockIdx.x, b = bc / d.C, c = bc % d.C, h = blockIdx.y;
  const int Q = d.Q, P = d.P, N = d.N, s0 = c * Q;
  const int NP = N + 1, PP = P + 1, TP = kTile + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t PN = (size_t)P * N;

  extern __shared__ float smem[];
  float* cum_s = smem;              // [Q]
  float* dt_s = cum_s + Q;          // [Q]
  float* rowm_s = dt_s + Q;         // [Q]: Σ_j M_ij
  float* colm_s = rowm_s + Q;       // [Q]: Σ_i M_ij
  float* cterm_s = colm_s + Q;      // [Q]: C_i·exp(cum_i) h_inᵀ dy_i
  float* s_s = cterm_s + Q;         // [Q]: u_j·exp(T - cum_j) dh_out B_j
  float* xdu_s = s_s + Q;           // [Q]: x_j·du_j
  float* fn_s = xdu_s + Q;          // [32][N+1]: the held tile's C (A) or B (B)
  float* vn_s = fn_s + kTile * NP;  // [32][N+1]: the walked tile's B or C; state slices
  float* an_s = vn_s + kTile * NP;  // [32][N+1]: dC (A) or dB (B)
  float* fp_s = an_s + kTile * NP;  // [32][P+1]: the held tile's dy (A) or u (B)
  float* vp_s = fp_s + kTile * PP;  // [32][P+1]: the walked tile's u or dy
  float* ap_s = vp_s + kTile * PP;  // [32][P+1]: du (B)
  float* w_s = ap_s + kTile * PP;   // [32][33]
  float* v_s = w_s + kTile * TP;    // [32][33]
  float* m_s = v_s + kTile * TP;    // [32][33]
  float* red_s = m_s + kTile * TP;  // [kWarps]

  const XT* xb = x + b * st.x_b + h * st.x_h;
  const XT* dyb = dy + b * st.dy_b + h * st.dy_h;
  const BT* Bb = Bm + b * st.b_b;
  const BT* Cb = Cm + b * st.c_b;
  const float* cw = cum_ws + ((size_t)bc * d.H + h) * Q;
  const float* h_in = states + ((size_t)bc * d.H + h) * PN;
  const float* dh_out = dstates + ((size_t)bc * d.H + h) * PN;
  const bool has_h = c > 0;
  const bool has_dh = c < d.C - 1 || has_dfinal;
  const float a = A[h];

  const float* dtb = dt + b * st.dt_b + h;
  for (int q = tid; q < Q; q += kThreads) {
    cum_s[q] = cw[q];
    dt_s[q] = s0 + q < d.S ? dtb[(long long)(s0 + q) * st.dt_s] : 0.f;
    rowm_s[q] = colm_s[q] = cterm_s[q] = s_s[q] = xdu_s[q] = 0.f;
  }
  const float total = cw[Q - 1];
  // Σ dh_out ∘ h_in, in a fixed order
  float hdh = 0.f;
  if (has_h && has_dh) {
    float part = 0.f;
    for (size_t e = tid; e < PN; e += kThreads) part += dh_out[e] * h_in[e];
    part = warp_sum(part);
    if (lane == 0) red_s[warp] = part;
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) hdh += red_s[w];
  }
  __syncthreads();

  // rows [r0, r0 + 32) of an [S]-long operand into a [32][width + 1] tile,
  // scaled per row by `scale` (null: 1); zero past the chunk or S
  auto load_n = [&](float* dst, const BT* src, long long row_s, int r0) {
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int r = i / N, n = i - r * N, q = r0 + r;
      dst[r * NP + n] = q < Q && s0 + q < d.S ? to_f32(src[(long long)(s0 + q) * row_s + n])
                                              : 0.f;
    }
  };
  auto load_p = [&](float* dst, const XT* src, long long row_s, int r0, bool times_dt) {
    for (int i = tid; i < kTile * P; i += kThreads) {
      const int r = i / P, p = i - r * P, q = r0 + r;
      float v = 0.f;
      if (q < Q && s0 + q < d.S) {
        v = to_f32(src[(long long)(s0 + q) * row_s + p]);
        if (times_dt) v *= dt_s[q];
      }
      dst[r * PP + p] = v;
    }
  };
  // rows [p0, p0 + 32) of a [P][N] state into vn_s
  auto load_state = [&](const float* src, int p0) {
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int r = i / N, n = i - r * N;
      vn_s[r * NP + n] = p0 + r < P ? src[(size_t)(p0 + r) * N + n] : 0.f;
    }
  };
  // Σ over a row of `t` (width `width`, row stride `stride`) times `u`, a
  // warp a row, for the 32 rows of a tile
  auto row_dots = [&](const float* t, const float* u, int width, int stride, float* out,
                      int r0) {
    for (int r = warp; r < kTile; r += kWarps) {
      float part = 0.f;
      for (int k = lane; k < width; k += 32) part += t[r * stride + k] * u[r * stride + k];
      part = warp_sum(part);
      if (lane == 0 && r0 + r < Q) out[r0 + r] = part;
    }
  };

  // ---- sweep A: a tile of queries i, the key tiles j <= i
  for (int i0 = 0; i0 < Q; i0 += kTile) {
    load_n(fn_s, Cb, st.c_s, i0);
    load_p(fp_s, dyb, st.dy_s, i0, false);
    for (int i = tid; i < kTile * NP; i += kThreads) an_s[i] = 0.f;
    __syncthreads();
    if (has_h) {  // dC_i += exp(cum_i) h_inᵀ dy_i, over slices of 32 rows of h_in
      for (int p0 = 0; p0 < P; p0 += kTile) {
        load_state(h_in, p0);
        __syncthreads();
        const int np = min(kTile, P - p0);
        for (int i = tid; i < kTile * N; i += kThreads) {
          const int r = i / N, n = i - r * N;
          float acc = an_s[r * NP + n];
          for (int pp = 0; pp < np; ++pp) acc += fp_s[r * PP + p0 + pp] * vn_s[pp * NP + n];
          an_s[r * NP + n] = acc;
        }
        __syncthreads();
      }
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int r = i / N, n = i - r * N;
        if (i0 + r < Q) an_s[r * NP + n] *= expf(cum_s[i0 + r]);
      }
      __syncthreads();
      row_dots(fn_s, an_s, N, NP, cterm_s, i0);
    }
    for (int j0 = 0; j0 <= i0; j0 += kTile) {
      __syncthreads();  // vn_s, vp_s free
      load_n(vn_s, Bb, st.b_s, j0);
      load_p(vp_s, xb, st.x_s, j0, true);
      __syncthreads();
      score_tiles(fn_s, fp_s, vn_s, vp_s, cum_s, i0, j0, Q, P, N, w_s, v_s, m_s, tid);
      __syncthreads();
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int r = i / N, n = i - r * N;
        float acc = an_s[r * NP + n];
        for (int jj = 0; jj < kTile; ++jj) acc += v_s[r * TP + jj] * vn_s[jj * NP + n];
        an_s[r * NP + n] = acc;
      }
      if (tid < kTile) {
        float acc = 0.f;
        for (int jj = 0; jj < kTile; ++jj) acc += m_s[tid * TP + jj];
        if (i0 + tid < Q) rowm_s[i0 + tid] += acc;
      }
    }
    __syncthreads();
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int r = i / N, n = i - r * N, q = i0 + r;
      if (q < Q && s0 + q < d.S)
        dc_part[(((size_t)b * d.S + s0 + q) * d.H + h) * N + n] = an_s[r * NP + n];
    }
    __syncthreads();
  }

  // ---- sweep B: a tile of keys j, the query tiles i >= j
  for (int j0 = 0; j0 < Q; j0 += kTile) {
    load_n(fn_s, Bb, st.b_s, j0);
    load_p(fp_s, xb, st.x_s, j0, true);
    for (int i = tid; i < kTile * NP; i += kThreads) an_s[i] = 0.f;
    for (int i = tid; i < kTile * PP; i += kThreads) ap_s[i] = 0.f;
    __syncthreads();
    if (has_dh) {  // du_j += e dh_out B_j, dB_j += e dh_outᵀ u_j, e = exp(T - cum_j)
      for (int p0 = 0; p0 < P; p0 += kTile) {
        load_state(dh_out, p0);
        __syncthreads();
        const int np = min(kTile, P - p0);
        for (int e = tid; e < kTile * kTile; e += kThreads) {
          const int jj = e >> 5, pp = e & 31;
          if (pp < np) {
            float acc = 0.f;
            for (int n = 0; n < N; ++n) acc += fn_s[jj * NP + n] * vn_s[pp * NP + n];
            ap_s[jj * PP + p0 + pp] = acc;
          }
        }
        for (int i = tid; i < kTile * N; i += kThreads) {
          const int jj = i / N, n = i - jj * N;
          float acc = an_s[jj * NP + n];
          for (int pp = 0; pp < np; ++pp) acc += fp_s[jj * PP + p0 + pp] * vn_s[pp * NP + n];
          an_s[jj * NP + n] = acc;
        }
        __syncthreads();
      }
      for (int i = tid; i < kTile * PP; i += kThreads) {
        const int jj = i / PP;
        if (j0 + jj < Q) ap_s[i] *= expf(total - cum_s[j0 + jj]);
      }
      for (int i = tid; i < kTile * NP; i += kThreads) {
        const int jj = i / NP;
        if (j0 + jj < Q) an_s[i] *= expf(total - cum_s[j0 + jj]);
      }
      __syncthreads();
      row_dots(fp_s, ap_s, P, PP, s_s, j0);
    }
    for (int i0 = j0; i0 < Q; i0 += kTile) {
      __syncthreads();  // vn_s, vp_s free
      load_n(vn_s, Cb, st.c_s, i0);
      load_p(vp_s, dyb, st.dy_s, i0, false);
      __syncthreads();
      score_tiles(vn_s, vp_s, fn_s, fp_s, cum_s, i0, j0, Q, P, N, w_s, v_s, m_s, tid);
      __syncthreads();
      for (int i = tid; i < kTile * P; i += kThreads) {
        const int jj = i / P, p = i - jj * P;
        float acc = ap_s[jj * PP + p];
        for (int r = 0; r < kTile; ++r) acc += w_s[r * TP + jj] * vp_s[r * PP + p];
        ap_s[jj * PP + p] = acc;
      }
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int jj = i / N, n = i - jj * N;
        float acc = an_s[jj * NP + n];
        for (int r = 0; r < kTile; ++r) acc += v_s[r * TP + jj] * vn_s[r * NP + n];
        an_s[jj * NP + n] = acc;
      }
      if (tid < kTile) {
        float acc = 0.f;
        for (int r = 0; r < kTile; ++r) acc += m_s[r * TP + tid];
        if (j0 + tid < Q) colm_s[j0 + tid] += acc;
      }
    }
    __syncthreads();
    // dx = dt du, dB a head's own, and x·du (x from the operand: u / dt
    // would divide by a zero dt)
    XT* dxb = dx + ((size_t)b * d.S * d.H + h) * P;
    for (int i = tid; i < kTile * P; i += kThreads) {
      const int jj = i / P, p = i - jj * P, q = j0 + jj;
      if (q < Q && s0 + q < d.S)
        dxb[((size_t)s0 + q) * d.H * P + p] = from_f32<XT>(dt_s[q] * ap_s[jj * PP + p]);
    }
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int jj = i / N, n = i - jj * N, q = j0 + jj;
      if (q < Q && s0 + q < d.S)
        db_part[(((size_t)b * d.S + s0 + q) * d.H + h) * N + n] = an_s[jj * NP + n];
    }
    for (int r = warp; r < kTile; r += kWarps) {
      const int q = j0 + r;
      float part = 0.f;
      if (q < Q && s0 + q < d.S)
        for (int p = lane; p < P; p += 32)
          part += to_f32(xb[(long long)(s0 + q) * st.x_s + p]) * ap_s[r * PP + p];
      part = warp_sum(part);
      if (lane == 0 && q < Q) xdu_s[q] = part;
    }
    __syncthreads();
  }

  // ---- dcum, da = its reverse prefix sum, ddt and the head's dA
  if (tid < 32) {  // T's share: Σ_j s_j + exp(T) Σ dh_out ∘ h_in
    float part = 0.f;
    for (int q = tid; q < Q; q += 32) part += s_s[q];
    part = warp_sum(part);
    if (tid == 0) red_s[0] = part + expf(total) * hdh;
  }
  __syncthreads();
  for (int q = tid; q < Q; q += kThreads)
    rowm_s[q] = rowm_s[q] - colm_s[q] + cterm_s[q] - s_s[q] + (q == Q - 1 ? red_s[0] : 0.f);
  __syncthreads();
  chunk_suffix_sum(rowm_s, Q, tid);
  __syncthreads();
  for (int q = tid; q < Q; q += kThreads)
    if (s0 + q < d.S) ddt[((size_t)b * d.S + s0 + q) * d.H + h] = xdu_s[q] + a * rowm_s[q];
  if (tid < 32) {
    float part = 0.f;
    for (int q = tid; q < Q; q += 32) part += dt_s[q] * rowm_s[q];
    part = warp_sum(part);
    if (tid == 0) da_part[(size_t)bc * d.H + h] = part;
  }
}

// Pass 4: dB and dC over the heads, in order, a thread an element.
template <typename BT>
__global__ void __launch_bounds__(kThreads) ssd_bwd_reduce_kernel(
    const float* __restrict__ db_part, const float* __restrict__ dc_part, BT* __restrict__ dB,
    BT* __restrict__ dC, Dims d) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (size_t)d.B * d.S * d.N) return;
  const size_t row = e / d.N, n = e - row * d.N;
  const float* bp = db_part + row * d.H * d.N + n;
  const float* cp = dc_part + row * d.H * d.N + n;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < d.H; ++h) {
    sb += bp[(size_t)h * d.N];
    sc += cp[(size_t)h * d.N];
  }
  dB[e] = from_f32<BT>(sb);
  dC[e] = from_f32<BT>(sc);
}

// dA over rows and chunks, in order, a thread a head.
__global__ void __launch_bounds__(kThreads) ssd_bwd_reduce_da_kernel(
    const float* __restrict__ da_part, float* __restrict__ dA, Dims d) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= d.H) return;
  float s = 0.f;
  for (int bc = 0; bc < d.B * d.C; ++bc) s += da_part[(size_t)bc * d.H + h];
  dA[h] = s;
}

size_t chunk_smem(int Q) { return sizeof(float) * (2 * (size_t)Q + kTile * (kOutP + kOutN)); }

template <typename XT, typename BT>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                   const void* dy, const void* dfinal, void* dx, void* ddt, void* dA, void* dB,
                   void* dC, void* workspace, const Dims& d, const Strides& st,
                   cudaStream_t stream) {
  const size_t BCH = (size_t)d.B * d.C * d.H;
  float* cum_ws = static_cast<float*>(workspace);
  float* states = cum_ws + BCH * d.Q;
  float* dstates = states + BCH * d.P * d.N;
  float* db_part = dstates + BCH * d.P * d.N;
  float* dc_part = db_part + (size_t)d.B * d.S * d.H * d.N;
  float* da_part = dc_part + (size_t)d.B * d.S * d.H * d.N;
  const auto* xp = static_cast<const XT*>(x);
  const auto* dyp = static_cast<const XT*>(dy);
  const auto* bp = static_cast<const BT*>(Bm);
  const auto* cp = static_cast<const BT*>(Cm);
  const auto* dtp = static_cast<const float*>(dt);
  const auto* ap = static_cast<const float*>(A);

  const int n_tiles = (d.N + kOutN - 1) / kOutN;
  const int tiles = ((d.P + kOutP - 1) / kOutP) * n_tiles;
  const size_t smem1 = chunk_smem(d.Q);
  const size_t smem3 = sizeof(float) * grad_smem_floats(d.P, d.N, d.Q);
  if (smem1 > (size_t)kSmemLimit || smem3 > (size_t)kSmemLimit)
    return cudaErrorInvalidConfiguration;
  auto k1 = ssd_bwd_chunk_kernel<XT, BT>;
  auto k3 = ssd_bwd_grad_kernel<XT, BT>;
  cudaError_t err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return err;

  k1<<<dim3((unsigned)((size_t)tiles * 2 * d.B * d.C), d.H), kThreads, smem1, stream>>>(
      xp, dtp, ap, bp, cp, dyp, cum_ws, states, dstates, d, st, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t PN = (size_t)d.P * d.N;
  ssd_bwd_state_kernel<<<dim3((unsigned)((PN + kThreads - 1) / kThreads), d.H, d.B), kThreads,
                         0, stream>>>(cum_ws, states, dstates,
                                      static_cast<const float*>(dfinal), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k3<<<dim3(d.B * d.C, d.H), kThreads, smem3, stream>>>(
      xp, dtp, ap, bp, cp, dyp, cum_ws, states, dstates, dfinal != nullptr,
      static_cast<XT*>(dx), static_cast<float*>(ddt), db_part, dc_part, da_part, d, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t elems = (size_t)d.B * d.S * d.N;
  ssd_bwd_reduce_kernel<BT><<<(unsigned)((elems + kThreads - 1) / kThreads), kThreads, 0,
                              stream>>>(db_part, dc_part, static_cast<BT*>(dB),
                                        static_cast<BT*>(dC), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_reduce_da_kernel<<<(d.H + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      da_part, static_cast<float*>(dA), d);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch_bc(int bc_dtype, const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* dy, const void* dfinal,
                        void* dx, void* ddt, void* dA, void* dB, void* dC, void* workspace,
                        const Dims& d, const Strides& st, cudaStream_t stream) {
  switch (bc_dtype) {
    case 0:
      return launch<XT, float>(x, dt, A, Bm, Cm, dy, dfinal, dx, ddt, dA, dB, dC, workspace, d,
                               st, stream);
    case 1:
      return launch<XT, __nv_bfloat16>(x, dt, A, Bm, Cm, dy, dfinal, dx, ddt, dA, dB, dC,
                                       workspace, d, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory of the gradient pass's block, in bytes (the
// largest of the passes').
extern "C" size_t ssd_bwd_smem(int P, int N, int Q) {
  return sizeof(float) * grad_smem_floats(P, N, Q);
}

// Plain C entry point, bound with ctypes. dtype codes: 0 float32, 1
// bfloat16 (dy in x's type). `strides` holds 12 element strides: x (b, s,
// h), dt (b, s), Bm (b, s), Cm (b, s), dy (b, s, h). `dfinal` may be null.
// `workspace` holds ops._bwd_workspace_bytes. Returns the first launch's
// error (cudaGetLastError(), or the error of setting a kernel's
// shared-memory limit).
extern "C" int ssd_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, const void* dy, const void* dfinal, void* dx, void* ddt,
                       void* dA, void* dB, void* dC, void* workspace, int Bsz, int S, int H,
                       int P, int N, int Q, int x_dtype, int bc_dtype, const long long* strides,
                       void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0 || workspace == nullptr)
    return cudaErrorInvalidValue;
  const Dims d{Bsz, S, H, P, N, Q, (S + Q - 1) / Q};
  const long long* s = strides;
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case 0:
      return dispatch_bc<float>(bc_dtype, x, dt, A, Bm, Cm, dy, dfinal, dx, ddt, dA, dB, dC,
                                workspace, d, st, cs);
    case 1:
      return dispatch_bc<__nv_bfloat16>(bc_dtype, x, dt, A, Bm, Cm, dy, dfinal, dx, ddt, dA, dB,
                                        dC, workspace, d, st, cs);
    default:
      return cudaErrorInvalidValue;
  }
}
