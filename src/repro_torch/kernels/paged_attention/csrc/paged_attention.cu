// Paged decode attention for Hopper (sm_90a), CUDA C++: flash-decoding.
//
// Replaces the Pallas TPU kernel `paged_attention`
// (src/repro/kernels/paged_attention/kernel.py, body `_kernel`), and computes
// what `paged_attention_decode_ref` in ../ref.py computes: one query token per
// sequence attends over a paged KV pool read through a block table, with the
// current token's K/V (`k_new`/`v_new`, position lengths[b]-1) read from its
// operands instead of the pool. Without `k_new` it is `paged_attention_ref`.
// `paged_attention_split_ref` in ../ref.py is the same split-and-merge in
// plain PyTorch.
//
// Layouts (all contiguous):
//   q, out        [B, H, D]        f32 or bf16 (out in q's type)
//   k_new, v_new  [B, KH, D]       q's type, or null
//   k/v_pages     [N, T, KH, D]    f32, bf16 or int8; one layer's pool slice
//   block_tables  [B, P] int32;  lengths [B] int32
//   k/v_scales    [N] f32 per-page dequant scales (int8 pages only), indexed
//                 by the physical page id block_tables[b, p], not by p
//   workspace     [B, H, splits, D + 2] f32: each split's partial (acc[D],
//                 m, l), when splits > 1
//   launches      [1] int32 or null: the split pass's first block adds one
//                 a launch, so a run counts on the device the launches the
//                 card really ran, inside a replayed CUDA graph too
// Variants: GQA/MQA/MHA (H = KH*G), logit softcap cap*tanh(s/cap), sliding
// window (only [length-window, length) visible; pages wholly below it are
// skipped). Positions >= lengths[b] are masked and nothing is read past
// column ceil(lengths[b] / T) of the block table, whose padding may name
// another slot's live page. A row with length 0 reads nothing and writes
// zeros. D is 32, 64, 128, 160 or 256.
//
// What bounds it: bytes. At the serving path's shape (B=3, H=KH=16, D=64,
// T=16, a 24-column table, lengths 384/250/97) the visible K and V are
// 3.0 MB, ~0.9 us at 3.35 TB/s, against ~3 MFLOP. In practice, with 48
// (head, row) pairs, latency: how many page loads are in flight at once,
// and the launch.
//
// Design (flash-decoding):
// * Split pass. Grid (KV heads x head groups, B, splits). The host splits
//   the block table's P columns into `splits` ranges of `cols` columns from
//   P and the SM count alone (`_split_plan` in ../ops.py), never from
//   `lengths`, so a call needs no device-to-host sync; at the serving shape
//   that is 6 splits of 4 pages, 288 blocks on 132 SMs. A block covers one
//   KV head, the GB (<= 4) query heads of it that share each page, and its
//   column range clipped to the row's visible columns [lo/T, ceil(len/T)).
//   Each head of a block reads its own [T, D] tile of a page (rows of D
//   contiguous elements at a stride of KH*D); a block does not read a page
//   row's KH*D span whole, because one (head, row) pair per block is what
//   puts enough blocks on the card at batch 3.
// * Page loads. The block's warps take its pages in turn (warp w: pages
//   w, w+4, ...), so at the serving shape the four pages of a split are in
//   flight at once. Each warp copies its page's K and V tiles into its own
//   shared-memory ring of two stages with 16-byte `cp.async` and issues the
//   next page's copies before it computes on the current one (double
//   buffering); a warp touches only its own ring, so the loop has no block
//   barrier, only `__syncwarp`.
// * Arithmetic on warps. A lane owns eight consecutive elements of a key
//   row (one 16-byte shared-memory read in bf16), so D/8 lanes hold a key
//   and a warp step covers 32/(D/8) keys at once (4 at D = 64); q sits
//   pre-scaled in f32 registers. A score is a shuffle reduction over the
//   key's D/8 lanes (3 shuffles at D = 64). Where D/8 is not a power of two
//   (D = 160: 20 lanes) a warp step covers one key, the reduction runs over
//   all 32 lanes, and lanes 20-31 hold zeros in q and in every row, so they
//   add nothing and write nothing: simple, and 3/8 of the warp idle, a
//   layout to redesign when D = 160 matters for speed. The steps of a sub-tile of
//   16 rows are independent, so their shuffles overlap. The sub-tile's max
//   and sum cross the key groups with two shuffles, each key costs one exp,
//   and each lane adds p·v for its own key into its accumulator with no
//   shuffle; the key groups' accumulators add up once, after the last page.
//   Softmax state (m, l, acc) stays in f32 registers. The softcap (a
//   branch-free tanh) and the visibility mask are flat loops over a
//   sub-tile's scores, and the new token's K and V sit in registers (read
//   by the one warp whose page holds it, while its copies land), so
//   the unrolled body stays small: a loop run once or twice a block cannot
//   keep a large body in the instruction cache.
// * Merges. At the end the warps' states merge by log-sum-exp in shared
//   memory; the block writes its partial to the f32 workspace. An empty
//   split (no visible position) writes m = -inf, l = 0. A second, small
//   pass (grid (H, B)) merges the splits' partials by log-sum-exp and
//   writes out in q's type. With a single split the first pass writes out
//   itself and the second is not launched. Both launches happen inside the
//   one C entry point, so the wrapper counts one launch per call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 4;
// dynamic shared memory a block may take (the card allows 227 KB)
constexpr size_t kSmemBudget = 200 * 1024;

// x as the pool's type would hold it: the plain version inserts the new
// token into the gathered pool (bf16 rounds it; f32 and dequantized int8
// keep it)
template <typename KT> __device__ __forceinline__ float as_pool(float x) { return x; }
template <> __device__ __forceinline__ float as_pool<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// tanh without branches: 1 - 2/(e^{2x} + 1), x clamped to |x| <= 15 where
// tanh is +-1 in f32; absolute error ~1e-6
__device__ __forceinline__ float fast_tanh(float x) {
  x = fminf(fmaxf(x, -15.f), 15.f);
  return 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f);
}

// element i of a q-typed operand (f32 or bf16)
__device__ __forceinline__ float load_q(const void* p, size_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_q(void* p, size_t i, float x, bool bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(p)[i] = x;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

struct Args {
  const void* q;
  const void* k_new;
  const void* v_new;
  const void* k_pages;
  const void* v_pages;
  const int32_t* tables;
  const int32_t* lengths;
  const float* k_scales;
  const float* v_scales;
  void* out;  // written by the split pass when splits == 1, else null
  float* ws;  // [B, H, splits, D + 2] partials when splits > 1
  int* launches;  // the device's count of launches, or null
  int H, KH, G, T, P, cols, splits, q_bf16, window;
  float sm_scale, softcap;
};

// Shared memory of one block: per warp a ring of two stages of a page's K
// and V tiles, then per warp GB rows of (acc[D], m, l) for the merge.
template <typename KT>
size_t split_smem(int warps, int T, int D, int GB) {
  return (size_t)warps * (4 * (size_t)T * D * sizeof(KT) + (size_t)GB * (D + 2) * sizeof(float));
}

// eight consecutive elements of a pool row (16 bytes of bf16, 32 of f32,
// 8 of int8) from shared memory, as f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = v[i];
}
__device__ __forceinline__ void load8(const int8_t* p, float (&x)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(c[i]);
}

template <typename KT, int D, int GB>
__global__ void __launch_bounds__(kMaxWarps * 32) paged_split_kernel(Args a) {
  constexpr int EPL = 8;                       // elements of a key row a lane owns
  constexpr int LPK = D / EPL;                 // lanes a key: 4, 8, 16, 20, 32
  // lanes a score's reduction spans: LPK, or the whole warp where LPK is
  // not a power of two (D = 160), whose lanes LPK.. then hold zeros
  constexpr int RED = (LPK & (LPK - 1)) == 0 ? LPK : 32;
  constexpr int KPS = 32 / RED;                // keys a warp step covers: 8, 4, 2, 1
  constexpr int NS = KPS >= 2 ? 16 / KPS : 8;  // warp steps a sub-tile (16 or 8 rows)
  constexpr int kVec = 16 / (int)sizeof(KT);   // elements of one 16-byte copy
  constexpr int kChunks = D / kVec;            // 16-byte copies a row
  constexpr int RS = D + 2;                    // a partial's row: acc[D], m, l
  const int HG = (a.G + GB - 1) / GB;
  const int kh = blockIdx.x / HG;
  const int g0 = (blockIdx.x - kh * HG) * GB;
  const int ng = min(GB, a.G - g0);
  const int b = blockIdx.y, split = blockIdx.z;
  if (a.launches != nullptr && blockIdx.x == 0 && b == 0 && split == 0 && threadIdx.x == 0)
    atomicAdd(a.launches, 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int kg = lane / RED;         // which key of a warp step this lane works on
  const int dl = lane - kg * RED;    // ... and which eight of its D elements
  const bool active = RED == LPK || dl < LPK;  // this lane holds elements of a key
  const int T = a.T;
  const int tile = T * D;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  KT* ring = reinterpret_cast<KT*>(smem_raw) + (size_t)warp * 4 * tile;  // [stage][K|V][T][D]
  float* merge = reinterpret_cast<float*>(smem_raw + (size_t)nw * 4 * tile * sizeof(KT));

  const int length = a.lengths[b];
  const int lo = a.window > 0 ? max(0, length - a.window) : 0;
  const int n_cols = min(a.P, (length + T - 1) / T);
  const int c_begin = max(split * a.cols, lo / T);
  const int c_end = min((split + 1) * a.cols, n_cols);
  const int new_pos = a.k_new != nullptr ? length - 1 : -1;
  const size_t row_stride = (size_t)a.KH * D;  // between token rows of one head
  const size_t new_off = ((size_t)b * a.KH + kh) * D + dl * EPL;

  float qv[GB][EPL], acc[GB][EPL], m[GB], l[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    const size_t qo = ((size_t)b * a.H + kh * a.G + g0 + min(g, ng - 1)) * D + dl * EPL;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      qv[g][e] = active ? load_q(a.q, qo + e, a.q_bf16) * a.sm_scale : 0.f;
      acc[g][e] = 0.f;
    }
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  auto issue = [&](int c, int stage) {
    const size_t page = (size_t)a.tables[(size_t)b * a.P + c];
    const size_t base = (page * T * a.KH + kh) * D;
    const KT* ks = static_cast<const KT*>(a.k_pages) + base;
    const KT* vs = static_cast<const KT*>(a.v_pages) + base;
    KT* kd = ring + stage * 2 * tile;
    KT* vd = kd + tile;
    for (int i = lane; i < T * kChunks; i += 32) {
      const int t = i / kChunks, x = (i - t * kChunks) * kVec;
      cp_async16(kd + t * D + x, ks + t * row_stride + x);
      cp_async16(vd + t * D + x, vs + t * row_stride + x);
    }
  };
  // this lane's eight elements of the new token's K and V, read by the warp
  // whose page holds the token
  float k_fresh[EPL] = {}, v_fresh[EPL] = {};
  // one K or V row's eight elements of this lane, or zeros where the row is
  // not visible; the new token's from registers
  auto row8 = [&](const KT* tile_s, const float (&fresh)[EPL], int row, bool vis, int pos,
                  float sc, float (&x)[EPL]) {
    if (vis && active) {
      load8(tile_s + row * D + dl * EPL, x);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) x[e] = 0.f;
    }
    const bool fresh_row = pos == new_pos;
#pragma unroll
    for (int e = 0; e < EPL; ++e) x[e] = fresh_row ? fresh[e] : x[e] * sc;
  };

  int c = c_begin + warp;
  if (c < c_end) issue(c, 0);
  cp_async_commit();
  for (int stage = 0; c < c_end; c += nw, stage ^= 1) {
    if (c + nw < c_end) issue(c + nw, stage ^ 1);
    cp_async_commit();
    if (active && new_pos >= c * T && new_pos < (c + 1) * T) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        k_fresh[e] = as_pool<KT>(load_q(a.k_new, new_off + e, a.q_bf16));
        v_fresh[e] = as_pool<KT>(load_q(a.v_new, new_off + e, a.q_bf16));
      }
    }
    cp_async_wait_all_but_one();  // this page's copies (this lane's) have landed
    __syncwarp();                 // ... and every lane's
    const KT* kt = ring + stage * 2 * tile;
    const KT* vt = kt + tile;
    const int page = a.tables[(size_t)b * a.P + c];
    const float ksc = a.k_scales != nullptr ? a.k_scales[page] : 1.f;
    const float vsc = a.v_scales != nullptr ? a.v_scales[page] : 1.f;
    for (int r0 = 0; r0 < T; r0 += NS * KPS) {
      // scores of the sub-tile's rows: warp step st covers rows r0 + st*KPS ..,
      // this lane's key group row r0 + st*KPS + kg
      float sc[GB][NS];
      unsigned visible = 0;  // bit st: this lane's row of step st is visible
#pragma unroll
      for (int st = 0; st < NS; ++st) {
        const int row = r0 + st * KPS + kg;
        const int pos = c * T + row;
        const bool vis = row < T && pos >= lo && pos < length;
        visible |= (unsigned)vis << st;
        float kv[EPL];
        row8(kt, k_fresh, row, vis, pos, ksc, kv);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) s = fmaf(qv[g][e], kv[e], s);
#pragma unroll
          for (int o = RED / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          sc[g][st] = s;
        }
      }
      if (a.softcap > 0.f) {
        const float inv = 1.f / a.softcap;
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int st = 0; st < NS; ++st) sc[g][st] = a.softcap * fast_tanh(sc[g][st] * inv);
      }
#pragma unroll
      for (int g = 0; g < GB; ++g)
#pragma unroll
        for (int st = 0; st < NS; ++st) sc[g][st] = (visible >> st) & 1u ? sc[g][st] : -INFINITY;
      // the online-softmax update over the sub-tile; sc becomes p
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g >= ng) break;
        float mx = -INFINITY;
#pragma unroll
        for (int st = 0; st < NS; ++st) mx = fmaxf(mx, sc[g][st]);
#pragma unroll
        for (int o = RED; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[g], mx);
        if (m_new == -INFINITY) {  // nothing visible yet
#pragma unroll
          for (int st = 0; st < NS; ++st) sc[g][st] = 0.f;
          continue;
        }
        const float alpha = __expf(m[g] - m_new);
        float ps = 0.f;
#pragma unroll
        for (int st = 0; st < NS; ++st) {
          sc[g][st] = __expf(sc[g][st] - m_new);
          ps += sc[g][st];
        }
#pragma unroll
        for (int o = RED; o < 32; o <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
        l[g] = l[g] * alpha + ps;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
        m[g] = m_new;
      }
#pragma unroll
      for (int st = 0; st < NS; ++st) {
        const int row = r0 + st * KPS + kg;
        const int pos = c * T + row;
        const bool vis = row < T && pos >= lo && pos < length;
        float vv[EPL];
        row8(vt, v_fresh, row, vis, pos, vsc, vv);
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(sc[g][st], vv[e], acc[g][e]);
      }
    }
    __syncwarp();  // every lane is done with this stage before it is refilled
  }

  // the key groups' accumulators add up; then the warps merge by log-sum-exp
  float* mine = merge + (size_t)warp * GB * RS;
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g >= ng) break;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
#pragma unroll
      for (int o = RED; o < 32; o <<= 1) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      if (kg == 0 && active) mine[g * RS + dl * EPL + e] = acc[g][e];
    }
    if (lane == 0) {
      mine[g * RS + D] = m[g];
      mine[g * RS + D + 1] = l[g];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * D; i += blockDim.x) {
    const int g = i / D, d = i - g * D;
    float M = -INFINITY;
    for (int w = 0; w < nw; ++w) M = fmaxf(M, merge[(w * GB + g) * RS + D]);
    float A = 0.f, L = 0.f;
    if (M != -INFINITY) {
      for (int w = 0; w < nw; ++w) {
        const float* r = merge + (w * GB + g) * RS;
        const float wgt = __expf(r[D] - M);
        A = fmaf(wgt, r[d], A);
        L = fmaf(wgt, r[D + 1], L);
      }
    }
    const int h = kh * a.G + g0 + g;
    if (a.out != nullptr) {
      store_q(a.out, ((size_t)b * a.H + h) * D + d, L > 0.f ? A / L : 0.f, a.q_bf16);
    } else {
      float* part = a.ws + (((size_t)b * a.H + h) * a.splits + split) * RS;
      part[d] = A;
      if (d == 0) {
        part[D] = M;
        part[D + 1] = L;
      }
    }
  }
}

// Second pass: merge the splits' partials of one (head, row) by log-sum-exp.
__global__ void paged_combine_kernel(const float* __restrict__ ws, void* out, int H, int D,
                                     int splits, int q_bf16) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int RS = D + 2;
  const float* part = ws + ((size_t)b * H + h) * splits * RS;
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, part[s * RS + D]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float A = 0.f, L = 0.f;
    if (M != -INFINITY) {
      for (int s = 0; s < splits; ++s) {
        const float* r = part + s * RS;
        const float wgt = __expf(r[D] - M);
        A = fmaf(wgt, r[d], A);
        L = fmaf(wgt, r[D + 1], L);
      }
    }
    store_q(out, ((size_t)b * H + h) * D + d, L > 0.f ? A / L : 0.f, q_bf16);
  }
}

// the query heads one block covers: the smallest power of two >= G, at most
// 4 (each costs 16 registers a lane for q and the accumulator)
int heads_per_block(int G) {
  int gb = 1;
  while (gb < G && gb < 4) gb *= 2;
  return gb;
}

// warps a block runs: one per page of its range, at most kMaxWarps, and
// as many as the shared-memory budget allows
template <typename KT>
int warps_per_block(int cols, int T, int D, int GB) {
  int w = min(kMaxWarps, cols);
  while (w > 0 && split_smem<KT>(w, T, D, GB) > kSmemBudget) --w;
  return w;
}

template <typename KT, int D, int GB>
cudaError_t launch_split(const Args& a, int B, cudaStream_t stream) {
  const int warps = warps_per_block<KT>(a.cols, a.T, D, GB);
  if (warps == 0) return cudaErrorInvalidConfiguration;
  const size_t smem = split_smem<KT>(warps, a.T, D, GB);
  auto kernel = paged_split_kernel<KT, D, GB>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(a.KH * ((a.G + GB - 1) / GB), B, a.splits);
  kernel<<<grid, warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename KT, int D>
cudaError_t dispatch_gb(const Args& a, int B, cudaStream_t stream) {
  switch (heads_per_block(a.G)) {
    case 1:
      return launch_split<KT, D, 1>(a, B, stream);
    case 2:
      return launch_split<KT, D, 2>(a, B, stream);
    case 4:
      return launch_split<KT, D, 4>(a, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename KT>
cudaError_t dispatch_d(int D, const Args& a, int B, cudaStream_t stream) {
  switch (D) {
    case 32:
      return dispatch_gb<KT, 32>(a, B, stream);
    case 64:
      return dispatch_gb<KT, 64>(a, B, stream);
    case 128:
      return dispatch_gb<KT, 128>(a, B, stream);
    case 160:
      return dispatch_gb<KT, 160>(a, B, stream);
    case 256:
      return dispatch_gb<KT, 256>(a, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory of one split-pass block at its largest (four warps), bytes.
extern "C" size_t paged_attention_decode_smem(int G, int D, int T, int kv_dtype) {
  const int gb = heads_per_block(G);
  switch (kv_dtype) {
    case 0:
      return split_smem<float>(kMaxWarps, T, D, gb);
    case 1:
      return split_smem<__nv_bfloat16>(kMaxWarps, T, D, gb);
    default:
      return split_smem<int8_t>(kMaxWarps, T, D, gb);
  }
}

// Plain C entry point, bound with ctypes. dtype codes: 0 float32, 1 bfloat16,
// 2 int8 (pages only). softcap <= 0 and window <= 0 mean none. `splits`
// ranges of `cols` block-table columns; with splits > 1 `workspace` holds
// B*H*splits*(D+2) floats and a second pass merges them. `launch_counter`
// (one int32 on the device, or null) counts the launches the device ran.
// Returns the first non-zero cudaError_t of the launches (0 when both
// launched).
extern "C" int paged_attention_decode(const void* q, const void* k_new, const void* v_new,
                                      const void* k_pages, const void* v_pages,
                                      const void* block_tables, const void* lengths,
                                      const void* k_scales, const void* v_scales, void* out,
                                      void* workspace, void* launch_counter, int B, int H,
                                      int KH, int D, int T,
                                      int P, int splits, int cols, int q_dtype, int kv_dtype,
                                      float sm_scale, float softcap, int window, void* stream) {
  if (B <= 0 || KH <= 0 || H % KH != 0 || D <= 0 || T <= 0 || P <= 0 || splits <= 0 ||
      cols <= 0 || (long long)splits * cols < P || (splits > 1 && workspace == nullptr) ||
      (q_dtype != 0 && q_dtype != 1))
    return cudaErrorInvalidValue;
  Args a{q,        k_new,    v_new, k_pages, v_pages,
         static_cast<const int32_t*>(block_tables), static_cast<const int32_t*>(lengths),
         static_cast<const float*>(k_scales), static_cast<const float*>(v_scales),
         splits == 1 ? out : nullptr, static_cast<float*>(workspace),
         static_cast<int*>(launch_counter),
         H,        KH,       H / KH, T,      P,       cols, splits, q_dtype, window,
         sm_scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kv_dtype) {
    case 0:
      err = dispatch_d<float>(D, a, B, s);
      break;
    case 1:
      err = dispatch_d<__nv_bfloat16>(D, a, B, s);
      break;
    case 2:
      err = dispatch_d<int8_t>(D, a, B, s);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return err;
  paged_combine_kernel<<<dim3(H, B), min(D, 256), 0, s>>>(static_cast<const float*>(workspace),
                                                         out, H, D, splits, q_dtype);
  return cudaGetLastError();
}
