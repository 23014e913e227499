// Flash attention, forward.
//
// Replaces: paddle_tpu/ops/flash_attention.py `_attn_kernel` (the Pallas
// TPU kernel that `_flash_forward` launches under the `_flash`
// custom_vjp).
//
// What it computes, per batch b, head h and query position t of
// q, k, v [B, T, H, D] (the JAX layout, read in place -- no transpose):
//   score     (q . k) * (1/sqrt(D)), products accumulated in f32;
//   mask      key kp < min(key_lens[b], Tk); with `causal` also t >= kp,
//             and with a `window` also t - kp < window;
//   softmax   streaming, in f32 (m, l, acc), with p ZEROED where a key is
//             invalid, so a row with no valid key returns 0;
//   output    o [B, T, H, D] in the input dtype, and the row log-sum-exp
//             lse [B, H, T] in f32 (m + log max(l, 1e-30)).
// For bf16 inputs p is rounded to bf16 before the PV product, as the TPU
// kernel feeds p.astype(v.dtype) to the MXU; l sums the unrounded p.
//
// What bounds it on an H100: by the data, operations for long rows (4*D
// flops per (query, key) pair, and one exp, against ~2*D*itemsize bytes
// per key read once), bytes for short ones. As built, the K/V tile loads
// from L2 and the softmax bound it, not the tensor cores (timed by
// scripts/torch_flash_tiles.py, which removes parts of the tile loop from
// copies of this source): each CTA reads the
// K/V prefix its rows need, so a long causal call moves T/64 times K and
// V from L2 (4.3 GB at B=4, T=8192, H=8).
//
// Design: FlashAttention-2's shape, on the tensor cores through
// `mma.sync`. A CTA of 4 warps owns 64 query rows of one (b, h), 16 per
// warp, and walks the key tiles that its rows need: a tile with no valid
// key for any of its rows is skipped whole, and the element masks
// (key_lens, causal, window) run only in a tile that crosses a boundary.
// S = Q K^T and O += P V are `mma.sync` products with f32 accumulators in
// registers; the online softmax runs on S's accumulator fragment (each
// row's max takes two quad shuffles; l is kept per thread and summed over
// the quad once, at the end; exp2 on the SFU with the scale folded into
// one FMA), and P passes from S's accumulators straight into the A
// fragment of the PV product, never through shared memory.
//   bf16: m16n8k16 bf16 products; Q's fragments loaded into registers
//     once, K's and V's by `ldmatrix` (`.trans` for V), each k-step's
//     loaded before the previous k-step's products issue.
//   f32: 3xTF32 m16n8k8 products: each operand x splits into hi =
//     tf32(x) and lo = tf32(x - hi), and a b = a_hi b_hi + a_hi b_lo +
//     a_lo b_hi, for S and for PV. Single-pass TF32 keeps ~11 bits, an
//     error of ~1e-3 on unit-scale scores, ten times f32's 1e-4. Each
//     key tile's PV sum starts from zero and is added to O in f32. Q's
//     fragments are read from shared memory at each k-step, which leaves
//     the registers to S, O and the split operands. P's fragment pairs
//     keys (2i, 2i+1) where the m16n8k8 A layout wants (i, i+4): PV's k
//     index is permuted, and V's fragment is read with the same
//     permutation.
// K and V stay in the input dtype in shared memory (bf16 is not widened)
// and arrive by 16-byte `cp.async` into a ring of kStages tiles of kKeys
// keys (`Tiling`), one barrier per tile: after it, the stage that the
// previous tile used takes the tile kStages - 1 ahead. Rows are padded by
// 16 bytes, so the `ldmatrix` rows and the f32 fragment loads are free of
// bank conflicts. Shared memory is dynamic (Q and the ring). The grid is
// ordered so that each SM's first CTAs pair a long causal query tile
// with a short one.
// Not here: `wgmma`, TMA and warp specialisation (FlashAttention-3).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // query rows per CTA, 16 per warp
constexpr float kMask = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Keys per tile and tiles in the ring, by (dtype, head_dim): chosen by
// scripts/torch_flash_tiles.py on the H100 (PERF.md).
template <typename T, int D>
struct Tiling;
template <>
struct Tiling<__nv_bfloat16, 64> {
  static constexpr int kKeys = 32, kStages = 3;
};
template <>
struct Tiling<__nv_bfloat16, 128> {
  static constexpr int kKeys = 64, kStages = 2;
};
template <int D>
struct Tiling<float, D> {
  static constexpr int kKeys = 32, kStages = 2;
};

template <typename T, int D>
struct Traits {
  static constexpr int kKeys = Tiling<T, D>::kKeys;
  static constexpr int kStages = Tiling<T, D>::kStages;
  static constexpr int kNB = kKeys / 8;                // S's n-blocks
  static constexpr int kLd = D + 16 / (int)sizeof(T);  // padded row
  // shared memory: Q [kRows][kLd], K and V [kStages][kKeys][kLd]
  static constexpr size_t kBytes =
      (size_t)(kRows + 2 * kStages * kKeys) * kLd * sizeof(T);
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, zeros where !ok (nothing read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + kN) of one (b, h) of x [B, Tn, H, D] (x points at row
// 0 of the (b, h), rows ld apart) into tile [kN][kLd], zeros past Tn:
// 16-byte copies, neighbouring threads along head_dim.
template <typename T, int D, int kN, int kLd>
__device__ __forceinline__ void load_tile(T* tile, const T* x, long long ld,
                                          int Tn, int r0) {
  constexpr int kVec = 16 / sizeof(T), kPerRow = D / kVec;
  static_assert(kN * kPerRow % kThreads == 0, "tile split");
#pragma unroll
  for (int it = 0; it < kN * kPerRow / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads;
    const int r = e / kPerRow, c = (e % kPerRow) * kVec;
    const bool ok = r0 + r < Tn;
    cp_async16(tile + r * kLd + c, x + (ok ? r0 + r : 0) * ld + c, ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a b on the tensor cores, 16 x 8 f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo, both TF32 (round to nearest, ties away)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}
template <int N>
__device__ __forceinline__ void split_tf32(const float (&x)[N],
                                           unsigned (&hi)[N],
                                           unsigned (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split_tf32(x[i], hi[i], lo[i]);
}

// c += a b in 3xTF32, the small cross terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const unsigned (&ah)[4],
                                           const unsigned (&al)[4],
                                           const unsigned (&bh)[2],
                                           const unsigned (&bl)[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// 2^x on the SFU (relative error ~2^-22; subnormal results flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// The warp's products, by dtype. Thread (g = lane / 4, c = lane % 4)
// holds rows g and g + 8 of its warp's 16; S's n-block nb holds keys 8 nb
// + 2c, 2c + 1 (s[nb][0..1] of row g, s[nb][2..3] of row g + 8), O's
// n-block dn dims 8 dn + 2c, 2c + 1 likewise.
template <typename T, int D>
struct Frag;

template <int D>
struct Frag<__nv_bfloat16, D> {
  using T = __nv_bfloat16;
  static constexpr int kNB = Traits<T, D>::kNB, kLd = Traits<T, D>::kLd;
  unsigned qa[D / 16][4];  // Q's A fragments, one per k-step of 16 dims

  __device__ __forceinline__ void load_q(const T* qs, int warp, int lane) {
    // matrices (rows 0-7 | 8-15) x (dims 0-7 | 8-15) of the k-step
    const T* p = qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                 ((lane >> 4) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(qa[kk], p + kk * 16);
  }

  // K's B fragments of k-step kk: n-blocks (2 np, 2 np + 1) in b[np]
  __device__ __forceinline__ void load_k(unsigned (&b)[kNB / 2][4],
                                         const T* p, int kk) const {
#pragma unroll
    for (int np = 0; np < kNB / 2; ++np)
      ldmatrix_x4(b[np], p + np * 16 * kLd + kk * 16);
  }

  // The fragments of the next k-step are loaded before this one's
  // products, so that the warp's in-order issue does not wait on them.
  __device__ __forceinline__ void scores(float (&s)[kNB][4], const T*,
                                         const T* kt, int, int lane) const {
    // matrices: keys (0-7 | 8-15) of a pair of n-blocks x dims (0-7 | 8-15)
    const T* p = kt + ((lane & 7) + ((lane >> 4) & 1) * 8) * kLd +
                 ((lane >> 3) & 1) * 8;
    unsigned b[2][kNB / 2][4];
    load_k(b[0], p, 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if (kk + 1 < D / 16) load_k(b[(kk + 1) & 1], p, kk + 1);
#pragma unroll
      for (int np = 0; np < kNB / 2; ++np) {
        mma_bf16(s[2 * np], qa[kk], b[kk & 1][np][0], b[kk & 1][np][1]);
        mma_bf16(s[2 * np + 1], qa[kk], b[kk & 1][np][2], b[kk & 1][np][3]);
      }
    }
  }

  // V's B fragments of the k16 block kb: d n-blocks (2 dp, 2 dp + 1)
  __device__ __forceinline__ void load_v(unsigned (&b)[D / 16][4],
                                         const T* p, int kb) const {
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp)
      ldmatrix_x4_trans(b[dp], p + kb * 16 * kLd + dp * 16);
  }

  // acc += round_bf16(P) V
  __device__ __forceinline__ void pv(float (&acc)[D / 8][4],
                                     const float (&s)[kNB][4], const T* vt,
                                     int lane) const {
    // matrices (transposed): keys (0-7 | 8-15) x dims (0-7 | 8-15)
    const T* p = vt + ((lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                 ((lane >> 4) & 1) * 8;
    unsigned b[2][D / 16][4];
    load_v(b[0], p, 0);
#pragma unroll
    for (int kb = 0; kb < kNB / 2; ++kb) {
      if (kb + 1 < kNB / 2) load_v(b[(kb + 1) & 1], p, kb + 1);
      const unsigned pa[4] = {
          pack_bf16(s[2 * kb][0], s[2 * kb][1]),
          pack_bf16(s[2 * kb][2], s[2 * kb][3]),
          pack_bf16(s[2 * kb + 1][0], s[2 * kb + 1][1]),
          pack_bf16(s[2 * kb + 1][2], s[2 * kb + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        mma_bf16(acc[2 * dp], pa, b[kb & 1][dp][0], b[kb & 1][dp][1]);
        mma_bf16(acc[2 * dp + 1], pa, b[kb & 1][dp][2], b[kb & 1][dp][3]);
      }
    }
  }
};

template <int D>
struct Frag<float, D> {
  using T = float;
  static constexpr int kNB = Traits<T, D>::kNB, kLd = Traits<T, D>::kLd;

  __device__ __forceinline__ void load_q(const T*, int, int) {}

  __device__ __forceinline__ void scores(float (&s)[kNB][4], const T* qs,
                                         const T* kt, int warp,
                                         int lane) const {
    const int g = lane >> 2, c = lane & 3;
    const T* qp = qs + (warp * 16 + g) * kLd + c;  // A(row g, dim c)
    const T* p = kt + g * kLd + c;                 // B(dim c, key g)
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const T* q = qp + kk * 8;
      const float x[4] = {q[0], q[8 * kLd], q[4], q[8 * kLd + 4]};
      unsigned ah[4], al[4];
      split_tf32(x, ah, al);
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        const float b[2] = {p[nb * 8 * kLd + kk * 8],
                            p[nb * 8 * kLd + kk * 8 + 4]};
        unsigned bh[2], bl[2];
        split_tf32(b, bh, bl);
        mma_3xtf32(s[nb], ah, al, bh, bl);
      }
    }
  }

  // acc += P V, 3xTF32. The k index of n-block nb is permuted: A column c
  // (c + 4) is key 8 nb + 2c (2c + 1), where S's accumulators hold P. The
  // tile's products accumulate from zero and reach acc by f32 adds: the
  // tensor core truncates its f32 accumulator, and fed O itself over a
  // row of 8192 keys it shrank |o| by up to 1.2e-4 of the row's max. Two
  // passes over the head dim keep half the tile's sums live at a time,
  // which ran faster than one pass (PERF.md).
  __device__ __forceinline__ void pv(float (&acc)[D / 8][4],
                                     const float (&s)[kNB][4], const T* vt,
                                     int lane) const {
    const int g = lane >> 2, c = lane & 3;
    const T* p = vt + 2 * c * kLd + g;  // B(key 2c, dim g)
    constexpr int kDG = D / 16;          // column blocks a pass
#pragma unroll
    for (int d0 = 0; d0 < D / 8; d0 += kDG) {
      float t[kDG][4] = {};
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        const float x[4] = {s[nb][0], s[nb][2], s[nb][1], s[nb][3]};
        unsigned ah[4], al[4];
        split_tf32(x, ah, al);
#pragma unroll
        for (int dn = 0; dn < kDG; ++dn) {
          const float b[2] = {p[nb * 8 * kLd + (d0 + dn) * 8],
                              p[(nb * 8 + 1) * kLd + (d0 + dn) * 8]};
          unsigned bh[2], bl[2];
          split_tf32(b, bh, bl);
          mma_3xtf32(t[dn], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int dn = 0; dn < kDG; ++dn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d0 + dn][e] += t[dn][e];
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ lens,
                     T* __restrict__ o, float* __restrict__ lse, int H,
                     int Tq, int Tk, float scale, int causal, int window) {
  using Tr = Traits<T, D>;
  constexpr int kKeys = Tr::kKeys, kNB = Tr::kNB, kLd = Tr::kLd;
  constexpr int kStages = Tr::kStages, kTile = kKeys * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kRows][kLd]
  T* ks = qs + kRows * kLd;                // [kStages][kKeys][kLd]
  T* vs = ks + kStages * kTile;            // [kStages][kKeys][kLd]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  // Under a causal mask query tile t has t + 1 key tiles' work. The first
  // half of the grid takes the longest query tiles, longest first, the
  // second half the shortest, shortest first, so that the scheduler's
  // round of assignments gives an SM a long tile and a short one.
  const int half = (gridDim.y + 1) / 2;
  const int q0 = (blockIdx.y < half ? gridDim.y - 1 - blockIdx.y
                                    : blockIdx.y - half) * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c = lane & 3;
  const int len = min(lens[b], Tk);
  const int q_last = min(q0 + kRows, Tq) - 1;
  const bool win = causal && window > 0;
  const long long ld = (long long)H * D;  // row stride of q, k, v, o
  const T* kbh = k + ((long long)b * Tk * H + h) * D;
  const T* vbh = v + ((long long)b * Tk * H + h) * D;

  // the key tiles with a valid key for some row of the CTA: [j_beg, j_end)
  int j_end = (len + kKeys - 1) / kKeys;
  if (causal) j_end = min(j_end, q_last / kKeys + 1);
  const int j_beg = win ? max(0, q0 - window + 1) / kKeys : 0;
  auto issue = [&](int j) {  // tile j into its stage, as one group
    if (j < j_end) {
      const int st = (j - j_beg) % kStages;
      load_tile<T, D, kKeys, kLd>(ks + st * kTile, kbh, ld, Tk, j * kKeys);
      load_tile<T, D, kKeys, kLd>(vs + st * kTile, vbh, ld, Tk, j * kKeys);
    }
    cp_async_commit();
  };

  load_tile<T, D, kRows, kLd>(qs, q + ((long long)b * Tq * H + h) * D, ld,
                              Tq, q0);
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(j_beg + i);
  cp_async_wait<kStages - 1>();  // Q has landed; K/V tiles in flight
  __syncthreads();
  Frag<T, D> fr;
  fr.load_q(qs, warp, lane);

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m[2] = {kMask, kMask}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + g;  // rows row0 (i = 0), row0 + 8 (1)
  const float c2 = scale * kLog2e;

  for (int j = j_beg; j < j_end; ++j) {
    cp_async_wait<kStages - 2>();  // tile j has landed
    // every warp is done with tile j - 1: its stage takes tile j + S - 1
    __syncthreads();
    issue(j + kStages - 1);
    const int st = (j - j_beg) % kStages;

    float s[kNB][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
    fr.scores(s, qs, ks + st * kTile, warp, lane);

    // element masks only where the tile crosses a boundary for some row;
    // a masked score is kMask, and exp2 of it against any row max is 0
    const int k0 = j * kKeys;
    const bool full = k0 + kKeys <= len &&
                      (!causal || k0 + kKeys - 1 <= q0) &&
                      (!win || q_last - k0 < window);
    float mx[2] = {kMask, kMask};
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!full) {
          const int row = row0 + (e >> 1) * 8;
          const int kp = k0 + nb * 8 + 2 * c + (e & 1);
          bool ok = kp < len;
          if (causal) {
            ok = ok && row >= kp;
            if (window > 0) ok = ok && row - kp < window;
          }
          if (!ok) s[nb][e] = kMask;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    float base[2];  // m * scale * log2(e); 0 while a row has no valid key
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      base[i] = m_new == kMask ? 0.f : m_new * c2;
      const float alpha = ex2(m[i] * c2 - base[i]);
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        acc[dn][2 * i] *= alpha;
        acc[dn][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[nb][e], c2, -base[e >> 1]));
        l[e >> 1] += p;
        s[nb][e] = p;
      }
    fr.pv(acc, s, vs + st * kTile, lane);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = row0 + i * 8;
    if (row >= Tq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = o + ((long long)b * Tq + row) * ld + (long long)h * D + 2 * c;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      store2(orow + dn * 8, acc[dn][2 * i] / l_safe,
             acc[dn][2 * i + 1] / l_safe);
    if (c == 0)
      lse[(long long)bh * Tq + row] =
          (m[i] == kMask ? kMask : m[i] * scale) + logf(l_safe);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lens, void* o, void* lse, int B, int H,
                   int Tq, int Tk, float scale, int causal, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = Traits<T, D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + kRows - 1) / kRows);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lens),
      static_cast<T*>(o), static_cast<float*>(lse), H, Tq, Tk, scale, causal,
      window);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; window <= 0 means none. q [B, Tq, H,
// D], k/v [B, Tk, H, D], lens [B] int32 -> o [B, Tq, H, D], lse [B, H, Tq]
// f32. Returns the launch's cudaError_t.
extern "C" int flash_fwd(int dtype, int head_dim, const void* q,
                         const void* k, const void* v, const void* lens,
                         void* o, void* lse, int B, int H, int Tq, int Tk,
                         float scale, int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return (int)launch<float, 64>(q, k, v, lens, o, lse, B, H, Tq, Tk, scale,
                                  causal, window, s);
  if (dtype == 0 && head_dim == 128)
    return (int)launch<float, 128>(q, k, v, lens, o, lse, B, H, Tq, Tk,
                                   scale, causal, window, s);
  if (dtype == 1 && head_dim == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, lens, o, lse, B, H, Tq,
                                          Tk, scale, causal, window, s);
  if (dtype == 1 && head_dim == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, lens, o, lse, B, H, Tq,
                                           Tk, scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
