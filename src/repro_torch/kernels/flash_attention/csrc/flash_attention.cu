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
// (the padding between a bucketed prefix's real and padded length). The hole's
// lower end may instead be read from an int32 on the device (`hole_lo_dev`):
// a captured chunk prefill replays with the prefix's real length as a device
// operand, while its upper end and `q_offset`, the padded prefix length, are
// fixed per bucket. Each block reads it once, before any tile is skipped or
// masked, so the skip and the masks use one value.
// Probabilities are rounded to the input type before the P·V product, as
// `blockwise_attention` does; the softmax denominator sums them unrounded.
//
// Layouts: one kernel for both entry points, selected by strides (in
// elements; the head dimension has stride 1):
//   flash_attention    q [B, H, Sq, D], k/v [B, KH, Skv, D], out like q
//   prefill_attention  q [B, Sq, H, D], k/v [B, Skv, KH, D], out like q
// D is 32, 64, 128, 160 or 256; the type is f32 or bf16 (out in q's type).
// A query row that sees no key at all (every key masked) is written as 0;
// the plain versions return the mean of v there, a row no serving path
// produces (a causal query always sees itself).
//
// What bounds it: bytes at the serving path's shapes. qwen1.5-0.5b's
// monolithic prefill at S = 384 (H = KH = 16, D = 64, bf16, causal) moves
// q, k, v and out once (3.1 MB, ~0.94 us at 3.35 TB/s) against 0.30 GFLOP
// of useful products (~0.3 us at the bf16 tensor-core peak). In practice,
// with 96 blocks of work at that shape, the latency of one block's chain
// of kv tiles, and the instructions it issues (below).
//
// Two kernels, chosen by type:
//
// bf16 (`flash_mma_kernel`): tensor cores. One block of 8 warps per (q tile
// of 64 rows, head, batch row), in two groups of 4; each warp owns 16 query
// rows, and the two groups take every other live kv tile, so a q tile's
// chain of kv tiles is half as long. The q tile is read once into
// registers as `mma` A fragments (`ldmatrix` from a padded shared tile).
// Each group copies its K and V tiles of 64 rows into its own ring of
// shared stages with 16-byte `cp.async` (zero-filled past Skv; 3 stages at
// D <= 64, 2 above) and synchronises on its own named barrier, so the
// next tiles' copies are in flight while the current one is computed.
//   The head dimension sets three things at compile time (`mma_groups`,
// `mma_stages`, `mma_q_in_regs`). Up to D = 160 the layout above holds: two
// groups of two stages need 194 KB at D = 160, inside the 227 KB a block
// may opt into. At D = 256 two groups would need 297 KB, so one group of
// 4 warps runs every live tile (169 KB at two stages), and the q tile's
// fragments are read from shared memory at each k-step instead of held:
// with 128 f32 accumulator registers a lane for O, holding 64 more for Q
// would spill. Every loop bound is a multiple of D / 16 or D / 8, so
// D = 160 (10 k-steps, 20 chunks of 16 bytes a row) needs nothing else.
// S = Q·Kᵀ runs as `mma.sync.m16n8k16` bf16 -> f32 with K's B fragments
// from `ldmatrix`; the scores, the mask and the online softmax (base-2
// exponent, row max and sum over the four lanes of a row with shuffles)
// stay in registers in the accumulator's layout. The probabilities,
// rounded to bf16, become the A fragments of P·V directly (the accumulator
// of two 8-key tiles is the A fragment of one 16-key step), and V's B
// fragments come from `ldmatrix.trans`. At the end group 1 hands its
// (m, l, o) to group 0 through shared memory, which merges them by
// log-sum-exp and writes out. Shared rows are padded by 16 bytes, so the
// eight rows an `ldmatrix` reads fall in distinct banks. Blocks take q
// tiles from the last (the longest causal rows) to the first. Operands
// whose rows or starts are not 16-byte aligned (a stride that is not a
// multiple of 8 elements) cannot use `cp.async`; they run the CUDA-core
// kernel below in bf16.
//   What the chip runs taught (H100, S = 384): the loop body is what
// costs, not the copies or the products. With the softcap's tanhf and the
// mask written per element, each with its own branches, the unrolled body
// was tens of kilobytes of machine code, which a loop run a few times a
// block cannot keep in the instruction cache; removing the products or
// the exponentials barely changed the time. So the softcap (a branch-free
// tanh) and the mask (per-row bounds, skipped for tiles with nothing
// masked) are flat loops; that took the time from 14.5 to 8.3 us. Two
// groups beat one group of 4 warps at S = 384; at long S one group's
// smaller ring fits more blocks on an SM. The serving path's prefill is
// the former.
//
// f32 (`flash_attention_kernel`): CUDA cores, kept from the first port (no
// TF32: the f32 band is 2e-3). One block of 256 threads per (q tile of 64
// rows, head, batch row); a loop over kv tiles of 64 rows carries the
// online-softmax state in registers, each thread owns a 4 x 4 register
// micro-tile of the scores and 4 rows x D/16 columns of the accumulator,
// and the q, K and probability tiles sit in shared memory as f32.
//
// Both skip kv tiles that causality, the window, kv_lengths or the hole
// mask entirely before they are loaded, as the Pallas `pl.when(live)` does.
//
// Counting: given `launch_counter` (one int32 on the device), the first
// thread of block (0, 0, 0) adds one to it at each launch, so the launches a
// replayed CUDA graph ran are counted on the device too.
//
// Training: given an `lse` pointer (f32 [B, H, Sq], contiguous), both
// kernels also write each query row's natural log-sum-exp of its scaled
// (and capped) scores, -inf for a row that sees no key; the backward kernel
// (flash_attention_bwd.cu) recomputes the probabilities from it. With a null
// pointer (every serving call) nothing more is written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

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

// Device pointers beside the launch arguments, each optional (null): the
// hole's lower end, and the launch counter.
struct Extra {
  const int32_t* hole_lo;
  int* counter;
};

// The hole's lower end this block uses (read once from the device when
// given, else the launch argument); the first thread of block (0, 0, 0)
// counts the launch.
__device__ __forceinline__ int block_prologue(const int32_t* hole_lo_dev, int* launch_counter,
                                              int hole_lo) {
  if (launch_counter != nullptr && threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&
      blockIdx.z == 0)
    atomicAdd(launch_counter, 1);
  return hole_lo_dev != nullptr ? *hole_lo_dev : hole_lo;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int32_t* __restrict__ kv_lengths, T* __restrict__ out, float* __restrict__ lse,
    const int32_t* __restrict__ hole_lo_dev, int* __restrict__ launch_counter, Params pr) {
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
  const int hole_lo = block_prologue(hole_lo_dev, launch_counter, pr.hole_lo);

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
    if (pr.hole_hi > hole_lo && k0 >= hole_lo && k0 + kBK <= pr.hole_hi) continue;
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
                !(kpos >= hole_lo && kpos < pr.hole_hi);
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
    if (lse != nullptr && tx == 0)
      lse[((long long)b * pr.H + h) * pr.Sq + row] = l[r] > 0.f ? m[r] + logf(l[r]) : -INFINITY;
  }
}

// ------------------------------------------------------------ bf16: tensor cores
constexpr int kMmaWarps = 4;          // warps of a group: 16 query rows each
constexpr int kGroups = 2;            // warp groups, each over every other kv tile
constexpr int kMBQ = 16 * kMmaWarps;  // query rows per block
constexpr int kMBK = 64;              // key rows per kv tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
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
// tanh without branches, for the bf16 path: 1 - 2/(e^{2x} + 1), x clamped
// to |x| <= 15 where tanh is +-1 in f32; absolute error ~1e-6
__device__ __forceinline__ float fast_tanh(float x) {
  x = fminf(fmaxf(x, -15.f), 15.f);
  return 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// warp groups a block runs: two over alternate kv tiles up to D = 160, one
// at D = 256 (two would need 297 KB of shared memory)
template <int D> __host__ __device__ constexpr int mma_groups() { return D <= 160 ? kGroups : 1; }
// kv tiles a warp group keeps in flight: 3 stages at D <= 64 (117 KB a
// block at D = 64), 2 above (153 KB at D = 128, 194 KB at D = 160, 169 KB
// at D = 256 with one group)
template <int D> __host__ __device__ constexpr int mma_stages() { return D <= 64 ? 3 : 2; }
// the q tile's A fragments held in registers for the whole kv loop (up to
// D = 160: 40 registers a lane), else read from shared memory each k-step
template <int D> __host__ __device__ constexpr bool mma_q_in_regs() { return D <= 160; }

template <int D>
constexpr size_t mma_smem_bytes() {
  // q tile, then each group's stages of K and V, rows padded by 8 elements
  return sizeof(__nv_bfloat16) *
         (size_t)(kMBQ + mma_groups<D>() * 2 * mma_stages<D>() * kMBK) * (D + 8);
}

// the largest dynamic shared memory a block may opt into on Hopper
constexpr size_t kMaxSmem = 232448;
static_assert(mma_smem_bytes<160>() <= kMaxSmem && mma_smem_bytes<256>() <= kMaxSmem,
              "a head dimension's tiles do not fit in a block's shared memory");

__device__ __forceinline__ void group_barrier(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(kMmaWarps * 32));
}

template <int D>
__global__ void __launch_bounds__(mma_groups<D>() * kMmaWarps * 32) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ kv_lengths,
    __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
    const int32_t* __restrict__ hole_lo_dev, int* __restrict__ launch_counter, Params pr) {
  constexpr int RW = D + 8;       // padded shared row, elements
  constexpr int CH = D / 8;       // 16-byte chunks a row
  constexpr int KS = D / 16;      // k-steps of Q·Kᵀ
  constexpr int NT = kMBK / 8;    // 8-key score tiles
  constexpr int DT = D / 8;       // 8-column output tiles
  constexpr int S = mma_stages<D>();
  constexpr int G = mma_groups<D>();
  constexpr bool QR = mma_q_in_regs<D>();
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (pr.H / pr.KH);
  const int tid = threadIdx.x, lane = tid & 31;
  const int group = tid / (kMmaWarps * 32);  // which kv tiles: every G-th live one
  const int gtid = tid % (kMmaWarps * 32);   // thread within the group
  const int warp = gtid >> 5;                // query rows warp*16 .. +16

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kMBQ][RW]
  __nv_bfloat16* k_s = q_s + (kMBQ + group * 2 * S * kMBK) * RW;    // [S][kMBK][RW]
  __nv_bfloat16* v_s = k_s + S * kMBK * RW;                          // [S][kMBK][RW]

  const int q0 = qt * kMBQ;
  const __nv_bfloat16* qb = q + b * pr.q_b + h * pr.q_h;
  const __nv_bfloat16* kb = k + b * pr.k_b + kh * pr.k_h;
  const __nv_bfloat16* vb = v + b * pr.v_b + kh * pr.v_h;
  const int kv_len = kv_lengths != nullptr ? kv_lengths[b] : pr.Skv;
  const int kv_valid = min(pr.Skv, kv_len);
  const int hole_lo = block_prologue(hole_lo_dev, launch_counter, pr.hole_lo);

  // the kv positions any row of this tile can see
  const int q_first = pr.q_offset + q0;
  const int q_last = pr.q_offset + min(pr.Sq, q0 + kMBQ) - 1;
  int kv_end = kv_valid;
  if (pr.causal) kv_end = min(kv_end, q_last + 1);
  const int kv_begin = pr.window > 0 ? max(0, q_first - pr.window + 1) : 0;
  const bool has_hole = pr.hole_hi > hole_lo;
  const unsigned hole_w = has_hole ? pr.hole_hi - hole_lo : 0;  // keys in the hole
  auto next_live = [&](int k0) {
    while (k0 < kv_end && has_hole && k0 >= hole_lo && k0 + kMBK <= pr.hole_hi) k0 += kMBK;
    return k0;
  };
  auto load_kv = [&](int k0, int stage) {
    __nv_bfloat16* kd = k_s + stage * kMBK * RW;
    __nv_bfloat16* vd = v_s + stage * kMBK * RW;
    for (int i = gtid; i < kMBK * CH; i += kMmaWarps * 32) {
      const int r = i / CH, x = (i - r * CH) * 8;
      const int pos = k0 + r;
      const bool ok = pos < pr.Skv;
      cp_async16(kd + r * RW + x, ok ? kb + (long long)pos * pr.k_s + x : kb, ok);
      cp_async16(vd + r * RW + x, ok ? vb + (long long)pos * pr.v_s + x : vb, ok);
    }
  };

  for (int i = tid; i < kMBQ * CH; i += G * kMmaWarps * 32) {
    const int r = i / CH, x = (i - r * CH) * 8;
    const bool ok = q0 + r < pr.Sq;
    cp_async16(q_s + r * RW + x, ok ? qb + (long long)(q0 + r) * pr.q_s + x : qb, ok);
  }
  cp_async_commit();
  // the live tile n live tiles after k0; a group takes every G-th
  auto advance = [&](int k0, int n) {
    for (int i = 0; i < n; ++i) k0 = next_live(k0 + kMBK);
    return k0;
  };
  // the group's first S - 1 live kv tiles go in flight with the q tile
  int k0 = advance(next_live((kv_begin / kMBK) * kMBK), group);  // the tile to compute next
  int k_load = k0;  // the tile to load next
  for (int st = 0; st < S - 1; ++st) {
    if (k_load < kv_end) {
      load_kv(k_load, st);
      k_load = advance(k_load, G);
    }
    cp_async_commit();
  }
  cp_async_wait<S - 1>();  // the q tile has landed
  __syncthreads();

  // this lane's address of the q tile's A fragment at k-step 0
  const __nv_bfloat16* q_frag = q_s + (warp * 16 + (lane & 15)) * RW + (lane >> 4) * 8;
  uint32_t qf[QR ? KS : 1][4];
  if constexpr (QR) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) ldmatrix_x4(qf[ks], q_frag + ks * 16);
  }

  float o[DT][4];
#pragma unroll
  for (int t = 0; t < DT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // this lane's two query rows (g and g + 8 of the warp's 16)
  const int qpos0 = pr.q_offset + q0 + warp * 16 + (lane >> 2);
  const float scale2 = pr.sm_scale * kLog2e;

  for (int stage = 0; k0 < kv_end; stage = stage + 1 == S ? 0 : stage + 1) {
    cp_async_wait<S - 2>();  // this tile has landed (this thread's copies)
    group_barrier(group);    // ... the group's; and the last stage is free
    // refill the stage the previous tile used
    if (k_load < kv_end) {
      load_kv(k_load, stage == 0 ? S - 1 : stage - 1);
      k_load = advance(k_load, G);
    }
    cp_async_commit();
    const __nv_bfloat16* kt = k_s + stage * kMBK * RW;
    const __nv_bfloat16* vt = v_s + stage * kMBK * RW;

    float s[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if constexpr (!QR) ldmatrix_x4(qf[0], q_frag + ks * 16);
      const uint32_t(&a)[4] = qf[QR ? ks : 0];
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * RW + ks * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], a, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
      }
    }

    // scale (to base 2) with the softcap, then the mask where the tile needs
    // one; each a flat loop, so the unrolled body stays small
    if (pr.softcap > 0.f) {
      const float in = pr.sm_scale / pr.softcap, out2 = pr.softcap * kLog2e;
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = out2 * fast_tanh(s[t][e] * in);
    } else {
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] *= scale2;
    }
    const bool full = k0 + kMBK <= kv_valid && (!pr.causal || k0 + kMBK - 1 <= q_first) &&
                      (pr.window <= 0 || q_last - k0 < pr.window) &&
                      !(has_hole && k0 < pr.hole_hi && k0 + kMBK > hole_lo);
    if (!full) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // row r sees keys [lo, hi) outside the hole
        const int qpos = qpos0 + 8 * r;
        const int hi = pr.causal ? min(kv_valid, qpos + 1) : kv_valid;
        const int lo = pr.window > 0 ? qpos - pr.window + 1 : 0;
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kpos = k0 + t * 8 + (lane & 3) * 2 + c;
            const bool ok = kpos >= lo && kpos < hi && (unsigned)(kpos - hole_lo) >= hole_w;
            s[t][2 * r + c] = ok ? s[t][2 * r + c] : -INFINITY;
          }
      }
    }

    // online softmax, rows g (r = 0) and g + 8 (r = 1)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < NT; ++t) mx = fmaxf(mx, fmaxf(s[t][2 * r], s[t][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[r] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float p0 = exp2f(s[t][2 * r] - m_use);
        const float p1 = exp2f(s[t][2 * r + 1] - m_use);
        s[t][2 * r] = p0;
        s[t][2 * r + 1] = p1;
        sum += p0 + p1;
      }
      l[r] = l[r] * alpha + sum;  // this lane's columns; the row's four lanes add up at the end
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        o[t][2 * r] *= alpha;
        o[t][2 * r + 1] *= alpha;
      }
    }

    // O += P · V, P rounded to bf16 straight from the score accumulators
#pragma unroll
    for (int kk = 0; kk < kMBK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * RW +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pa, bf[0], bf[1]);
        mma_bf16(o[2 * dp + 1], pa, bf[2], bf[3]);
      }
    }
    k0 = advance(k0, G);
  }

  // with two groups, group 1 hands its state (m, l, o of each lane) to
  // group 0 through its own stages; group 0 merges by log-sum-exp (base 2)
  // and writes out
  if constexpr (G == 2) {
    constexpr int NTH = kMmaWarps * 32;
    static_assert((DT * 4 + 4) * NTH * sizeof(float) <= 2 * S * kMBK * RW * sizeof(__nv_bfloat16),
                  "the hand-off does not fit in group 1's stages");
    __syncthreads();
    float* hand = reinterpret_cast<float*>(q_s + (kMBQ + 2 * S * kMBK) * RW);  // [DT*4+4][128]
    if (group == 1) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        hand[(DT * 4 + r) * NTH + gtid] = m[r];
        hand[(DT * 4 + 2 + r) * NTH + gtid] = l[r];
      }
#pragma unroll
      for (int t = 0; t < DT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) hand[(t * 4 + e) * NTH + gtid] = o[t][e];
    }
    __syncthreads();
    if (group == 1) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = hand[(DT * 4 + r) * NTH + gtid];
      const float m_new = fmaxf(m[r], m1);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float a0 = exp2f(m[r] - m_use), a1 = exp2f(m1 - m_use);
      l[r] = l[r] * a0 + hand[(DT * 4 + 2 + r) * NTH + gtid] * a1;
      m[r] = m_new;
#pragma unroll
      for (int t = 0; t < DT; ++t) {
        o[t][2 * r] = o[t][2 * r] * a0 + hand[(t * 4 + 2 * r) * NTH + gtid] * a1;
        o[t][2 * r + 1] = o[t][2 * r + 1] * a0 + hand[(t * 4 + 2 * r + 1) * NTH + gtid] * a1;
      }
    }
  }

  __nv_bfloat16* ob = out + b * pr.o_b + h * pr.o_h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    const int row = q0 + warp * 16 + (lane >> 2) + r * 8;
    if (row >= pr.Sq) continue;
    // m is in base-2 units of the scaled scores
    if (lse != nullptr && (lane & 3) == 0)
      lse[((long long)b * pr.H + h) * pr.Sq + row] =
          sum > 0.f ? (m[r] + log2f(sum)) * 0.6931471805599453f : -INFINITY;
    __nv_bfloat16* orow = ob + (long long)row * pr.o_s + (lane & 3) * 2;
#pragma unroll
    for (int t = 0; t < DT; ++t)
      *reinterpret_cast<__nv_bfloat162*>(orow + t * 8) =
          __floats2bfloat162_rn(o[t][2 * r] * inv, o[t][2 * r + 1] * inv);
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* kv_lengths,
                       void* out, float* lse, const Extra& ex, int B, const Params& pr,
                       cudaStream_t stream) {
  constexpr size_t smem = mma_smem_bytes<D>();
  auto kernel = flash_mma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((pr.Sq + kMBQ - 1) / kMBQ, pr.H, B);
  kernel<<<grid, mma_groups<D>() * kMmaWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(kv_lengths),
      static_cast<__nv_bfloat16*>(out), lse, ex.hole_lo, ex.counter, pr);
  return cudaGetLastError();
}

// cp.async needs every row start on a 16-byte boundary: the base pointers,
// and strides that are multiples of 8 bf16 elements
bool mma_aligned(const void* q, const void* k, const void* v, const void* out, const Params& pr) {
  for (const void* p : {q, k, v, out})
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (long long st : {pr.q_b, pr.q_h, pr.q_s, pr.k_b, pr.k_h, pr.k_s, pr.v_b, pr.v_h, pr.v_s,
                       pr.o_b, pr.o_h, pr.o_s})
    if (st % 8) return false;
  return true;
}

cudaError_t dispatch_mma(int D, const void* q, const void* k, const void* v,
                         const void* kv_lengths, void* out, float* lse, const Extra& ex, int B,
                         const Params& pr, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_mma<32>(q, k, v, kv_lengths, out, lse, ex, B, pr, stream);
    case 64:
      return launch_mma<64>(q, k, v, kv_lengths, out, lse, ex, B, pr, stream);
    case 128:
      return launch_mma<128>(q, k, v, kv_lengths, out, lse, ex, B, pr, stream);
    case 160:
      return launch_mma<160>(q, k, v, kv_lengths, out, lse, ex, B, pr, stream);
    case 256:
      return launch_mma<256>(q, k, v, kv_lengths, out, lse, ex, B, pr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D +
                          (size_t)kBQ * (kBK + 1));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kv_lengths, void* out,
                   float* lse, const Extra& ex, int B, const Params& pr, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((pr.Sq + kBQ - 1) / kBQ, pr.H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(kv_lengths), static_cast<T*>(out), lse, ex.hole_lo, ex.counter,
      pr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const void* kv_lengths, void* out, float* lse, const Extra& ex, int B,
                       const Params& pr, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, kv_lengths, out, lse, ex, B, pr, stream);
    case 64:
      return launch<T, 64>(q, k, v, kv_lengths, out, lse, ex, B, pr, stream);
    case 128:
      return launch<T, 128>(q, k, v, kv_lengths, out, lse, ex, B, pr, stream);
    case 160:
      return launch<T, 160>(q, k, v, kv_lengths, out, lse, ex, B, pr, stream);
    case 256:
      return launch<T, 256>(q, k, v, kv_lengths, out, lse, ex, B, pr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory one block needs at head dimension D, in bytes: the f32
// (CUDA-core) kernel, and the bf16 (tensor-core) one.
extern "C" size_t flash_attention_smem(int D) { return smem_bytes(D); }
extern "C" size_t flash_attention_mma_smem(int D) {
  switch (D) {
    case 32:
      return mma_smem_bytes<32>();
    case 64:
      return mma_smem_bytes<64>();
    case 128:
      return mma_smem_bytes<128>();
    case 160:
      return mma_smem_bytes<160>();
    case 256:
      return mma_smem_bytes<256>();
    default:
      return 0;
  }
}

// Plain C entry point, bound with ctypes. dtype codes: 0 float32, 1 bfloat16
// (the tensor-core kernel when every row start is 16-byte aligned).
// Strides in elements; kv_lengths and lse may be null (lse: f32 [B, H, Sq],
// written when given); softcap <= 0 and window <= 0 mean none; hole_lo >=
// hole_hi means no hole. `hole_lo_dev` (one int32 on the device, or null)
// replaces `hole_lo` when given; `launch_counter` (one int32 on the device,
// or null) counts the launches the device ran. Returns the launch's
// cudaGetLastError() (or the error of setting the shared-memory limit).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* kv_lengths, void* out, void* lse, int B, int H,
                                   int KH,
                                   int Sq, int Skv, int D, int dtype, long long q_b,
                                   long long q_h, long long q_s, long long k_b, long long k_h,
                                   long long k_s, long long v_b, long long v_h, long long v_s,
                                   long long o_b, long long o_h, long long o_s, float sm_scale,
                                   float softcap, int causal, int window, int q_offset,
                                   int hole_lo, int hole_hi, const void* hole_lo_dev,
                                   void* launch_counter, void* stream) {
  if (B <= 0 || H <= 0 || KH <= 0 || H % KH != 0 || Sq <= 0 || Skv <= 0)
    return cudaErrorInvalidValue;
  const Params pr{H,   KH,  Sq,  Skv,      q_b,     q_h,    q_s,    k_b,     k_h,     k_s,
                  v_b, v_h, v_s, o_b,      o_h,     o_s,    sm_scale, softcap, causal, window,
                  q_offset, hole_lo, hole_hi};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const Extra ex{static_cast<const int32_t*>(hole_lo_dev), static_cast<int*>(launch_counter)};
  switch (dtype) {
    case 0:
      return dispatch_d<float>(D, q, k, v, kv_lengths, out, l, ex, B, pr, s);
    case 1:
      if (mma_aligned(q, k, v, out, pr))
        return dispatch_mma(D, q, k, v, kv_lengths, out, l, ex, B, pr, s);
      return dispatch_d<__nv_bfloat16>(D, q, k, v, kv_lengths, out, l, ex, B, pr, s);
    default:
      return cudaErrorInvalidValue;
  }
}
