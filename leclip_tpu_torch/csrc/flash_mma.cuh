// bf16 flash attention on the tensor cores, for sm_90a: the bf16 half of
// flash_attention.cu, which replaces leclip_tpu/ops/flash_attention.py
// flash_attention (_flash_kernel_single, _flash_kernel).
//
// Bound on the H100: per (sequence, head) 4*Tq*Tk*64 flops against
// (Tq + 2*Tk + Tq)*64*2 bytes, 2*Tk/4 flop/byte at Tq = Tk, under the 295
// ridge for every CLIP length: the bytes of q, k, v and o bound it (0.224 ms
// at the ViT-B/16 shape [610, 12, 200, 64]). The CUDA-core version this
// replaces widened bf16 to fp32 and did 75 GFLOP of FMAs (6.8 ms).
//
// Design: the primitives of attn_core.cuh (mma.sync m16n8k16 with bf16
// operands and fp32 sums, K fragments by ldmatrix, V fragments by
// ldmatrix.trans, K and V rows in shared memory by 16-byte cp.async, a warp
// per 16-query tile). A block holds one softmax block of K and V (all keys
// when Tk <= block_k, else block_k = 256 at a time) and takes up to 8 warps
// of query tiles of one (sequence, head); the query tiles of a head are
// split over several blocks where sequences x heads alone would not fill
// the card, or where the keys come in several softmax blocks (then every
// warp keeps one tile's running max, sum and accumulator across them).
//
// The TPU kernel's rounding points, whatever the tiling:
//   s = fl(fl(q.k * scale) + bias), the bias the mask clamped at -1e30;
//   Tk <= block_k (one key block): the row max m of s, the fp32 sum l of
//     e = exp(s - m), then p = bf16(e / l) and out = p.V. Two passes over
//     the keys: the first finds m exactly and sums e as it goes, each lane
//     against its own running max, rescaling its partial sum when that max
//     grows, the lanes' sums combined against m at the end (l then differs
//     from a sum taken after the max by fp32 rounding only); the second
//     forms p and p.V. Scores are recomputed from the K fragments in each
//     pass, which at Tk <= 256 is cheaper than spilling them;
//   Tk > block_k: at each block_k boundary m_cur = max(m, block max) (m
//     starts at -1e30, not -inf), corr = exp(m - m_cur), l = l*corr + sum of
//     the fp32 e, acc = acc*corr + bf16(e).V, out = acc / l at the end.
// Keys past Tk are the TPU's zero pad, biased -1e30: they add nothing to
// p.V and exp(-1e30 - m) each to l, which is 0 unless every key of the row
// is masked (then m = -1e30 and p is uniform over Tk rounded up to the key
// block, as the TPU kernel has it).
//
// The mask costs only where it is mixed. Each 32-key chunk of a tile is
// sorted first: all-zero bias, masked everywhere, or other (mixed, or the
// ragged last chunk). An all-zero chunk takes the fast path of attn_core:
// s is q.k * scale, so its max is taken on the raw products (exactly: the
// scale is a power of two) and e = ex2(q.k * scale * log2 e - m * log2 e)
// in one FMA, with no mask read and no branch inside. The others take the
// general path: s formed with its bias, e = ex2((s - m) * log2 e) with s - m
// formed first, exact where both sit at -1e30. A chunk masked for every row
// needs no products (its s are -1e30), never holds a max above -1e30, and
// is skipped once each row of the tile has a score above -1e29: its e then
// underflow to exactly 0 (causal tiles skip the keys past their diagonal; a
// fully masked row keeps them, and its uniform p). A [Tk] mask is staged in
// shared memory and sorted once per key block; a [Tq, Tk] mask is sorted
// once per call into a class map (classify_mask), read with one load a lane.
#pragma once

#include "attn_core.cuh"

namespace leclip {
namespace flash {

constexpr float NEG = -1e30f;  // the TPU wrapper's mask clamp and pad bias
constexpr float LOG2E = 1.4426950408889634f;
constexpr int LD = 64 + 8;     // K/V rows in shared memory: 16-byte aligned, conflict-free
constexpr int MAX_WARPS = 8;

enum Mask : int { NONE = 0, KEYS = 1, MATRIX = 2 };
enum Chunk : int { ZERO = 0, DEAD = 1, OTHER = 2 };
constexpr unsigned ZERO_BIT = 1, DEAD_BIT = 2;  // a chunk's entry in the class map

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  const float* mask;  // [tk] (KEYS) or [tq, tk] (MATRIX), fp32
  unsigned char* cls;  // MATRIX: the class map of classify_mask
  int n_heads, tq, tk, block_k;
  int n_qg;  // blocks per (sequence, head), each over tpg query tiles
  int tpg;
  long long q_sb, q_sh, q_st;  // element strides: sequence, head, row
  long long kv_sb, kv_sh, kv_st;
  long long o_sb, o_sh, o_st;
  float scale;
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One warp's 16 query rows against the keys [kb0, kb0 + n) held in ks / vs.
template <int MASK>
struct Tile {
  const float* mask;  // [tk] or [tq, tk]
  const float* bs;    // KEYS: this key block's clamped mask, in shared memory
  const unsigned char* cls;  // MATRIX: the class map of classify_mask
  long long q_st, o_st;
  int tq, tk;
  float scale;
  const bf16* k_lane;
  const bf16* v_lane;
  unsigned qa[4][4];
  int r0, r1, tq4, kb0, n;
  unsigned zero_bits, dead_bits;  // chunks of this key block whose bias is all 0 / all masked

  __device__ __forceinline__ void load_q(const bf16* qh, int q0, int lane) {
    r0 = q0 + (lane >> 2);
    r1 = r0 + 8;
    tq4 = lane & 3;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = (e & 1) ? r1 : r0;
        const int c = kk * 16 + ((e & 2) ? 8 : 0) + 2 * tq4;
        qa[kk][e] = row < tq ? ld32(qh + row * q_st + c) : 0u;
      }
    }
  }

  __device__ __forceinline__ int col(int kc, int nt, int e) const {
    return kc * 32 + nt * 8 + 2 * tq4 + (e & 1);
  }

  // the mask at one score, clamped at -1e30 (0 for rows past tq)
  __device__ __forceinline__ float bias(int kc, int nt, int e) const {
    if (MASK == NONE) return 0.f;
    const int c = min(col(kc, nt, e), n - 1);
    if (MASK == KEYS) return bs[c];
    const int row = e < 2 ? r0 : r1;
    return row < tq ? fmaxf(__ldg(mask + (long long)row * tk + kb0 + c), NEG) : 0.f;
  }

  // sort the chunks of this key block by their bias over the tile's real
  // rows: a [tk] mask from its copy in shared memory, one key per lane; a
  // [tq, tk] one from its class map, one chunk per lane
  __device__ __forceinline__ void classify(int lane, int qt) {
    const int n_chunks = (n + 31) / 32;
    bool zero = true, dead = false;
    if (MASK == KEYS) {
      zero_bits = dead_bits = 0;
      for (int kc = 0; kc < n_chunks; ++kc) {
        bool z = true, d = true;
        if (kc * 32 + lane < n) {
          const float b = bs[kc * 32 + lane];
          z = b == 0.f;
          d = b <= NEG;
        }
        if (__all_sync(0xffffffffu, d))
          dead_bits |= 1u << kc;
        else if (__all_sync(0xffffffffu, z))
          zero_bits |= 1u << kc;
      }
      return;
    }
    if (MASK == MATRIX) {
      const long long at = (long long)qt * ((tk + 31) / 32) + kb0 / 32 + lane;
      const unsigned c = lane < n_chunks ? cls[at] : 0u;
      dead = c & DEAD_BIT;
      zero = (c & ZERO_BIT) && !dead;
    }
    dead_bits = __ballot_sync(0xffffffffu, lane < n_chunks && dead);
    zero_bits = __ballot_sync(0xffffffffu, lane < n_chunks && zero);
  }

  // ZERO: all-zero bias over a whole chunk; DEAD: masked everywhere; OTHER
  __device__ __forceinline__ int chunk_class(int kc) const {
    if ((dead_bits >> kc) & 1) return DEAD;
    return ((zero_bits >> kc) & 1) && kc * 32 + 32 <= n ? ZERO : OTHER;
  }

  // the raw q.k of chunk kc
  __device__ __forceinline__ void products(int kc, float (&sc)[4][4]) const {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const bf16* kp = k_lane + (kc * 32 + nt * 8) * LD;
#pragma unroll
      for (int kk = 0; kk < 4; kk += 2) {
        unsigned b[4];
        ldsm_x4(b, kp + kk * 16);
        mma16816(sc[nt], qa[kk], b[0], b[1]);
        mma16816(sc[nt], qa[kk + 1], b[2], b[3]);
      }
    }
  }

  // s of a DEAD or OTHER chunk, -inf for keys past n. A DEAD chunk needs no
  // products: fl(q.k * scale - 1e30) is -1e30 (|q.k * scale| is far below
  // half its ulp).
  __device__ __forceinline__ void scores(int kc, int cls, float (&sc)[4][4]) const {
    if (cls == DEAD) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = NEG;
    } else {
      products(kc, sc);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[nt][e] = __fadd_rn(__fmul_rn(sc[nt][e], scale), bias(kc, nt, e));
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (col(kc, nt, e) >= n) sc[nt][e] = -INFINITY;
  }

  // e = exp(s - m) of the scores of scores(), in place, summed into (l0, l1)
  __device__ __forceinline__ void exps(float m0, float m1, float (&sc)[4][4], float& l0,
                                       float& l1) const {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      sc[nt][0] = fast_exp2((sc[nt][0] - m0) * LOG2E);
      sc[nt][1] = fast_exp2((sc[nt][1] - m0) * LOG2E);
      sc[nt][2] = fast_exp2((sc[nt][2] - m1) * LOG2E);
      sc[nt][3] = fast_exp2((sc[nt][3] - m1) * LOG2E);
      l0 += sc[nt][0] + sc[nt][1];
      l1 += sc[nt][2] + sc[nt][3];
    }
  }

  // e = exp(s - m) of the raw products of a ZERO chunk, in place, summed
  // into (l0, l1): one FMA and ex2 per score (every real row has finite s)
  __device__ __forceinline__ void exps_raw(float m0, float m1, float (&sc)[4][4], float& l0,
                                           float& l1) const {
    const float c = LOG2E * scale, n0 = -m0 * LOG2E, n1 = -m1 * LOG2E;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      sc[nt][0] = fast_exp2(fmaf(sc[nt][0], c, n0));
      sc[nt][1] = fast_exp2(fmaf(sc[nt][1], c, n0));
      sc[nt][2] = fast_exp2(fmaf(sc[nt][2], c, n1));
      sc[nt][3] = fast_exp2(fmaf(sc[nt][3], c, n1));
      l0 += sc[nt][0] + sc[nt][1];
      l1 += sc[nt][2] + sc[nt][3];
    }
  }

  __device__ __forceinline__ void row_max(const float (&sc)[4][4], float& a, float& b) const {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      a = fmaxf(a, fmaxf(sc[nt][0], sc[nt][1]));
      b = fmaxf(b, fmaxf(sc[nt][2], sc[nt][3]));
    }
  }

  // whether every real row of the tile has a score above -1e29 (given the
  // quad-reduced maxima): only then do the DEAD chunks add exactly nothing
  __device__ __forceinline__ bool rows_live(float m0, float m1) const {
    return __all_sync(0xffffffffu, (r0 >= tq || m0 > -1e29f) && (r1 >= tq || m1 > -1e29f));
  }

  // (m0, m1) = the max of (m0, m1) and this key block's s, quad-reduced. A
  // DEAD chunk cannot raise it (its s are -1e30 <= m).
  __device__ __forceinline__ void max_pass(float& m0, float& m1) const {
    float a = m0, b = m1, ra = -INFINITY, rb = -INFINITY;
    const int n_chunks = (n + 31) / 32;
    for (int kc = 0; kc < n_chunks; ++kc) {
      const int cls = chunk_class(kc);
      float sc[4][4];
      if (cls == ZERO) {
        products(kc, sc);
        row_max(sc, ra, rb);
      } else if (cls == OTHER) {
        scores(kc, cls, sc);
        row_max(sc, a, b);
      }
    }
    m0 = quad_max(fmaxf(a, ra * scale));
    m1 = quad_max(fmaxf(b, rb * scale));
  }

  // One key block's max m (quad-reduced) and l = sum of exp(s - m), in one
  // pass: each lane keeps its own running max, its partial sum rescaled by
  // exp(m_old - m_new) when that max grows; the lanes' sums are combined
  // against m at the end.
  __device__ __forceinline__ void max_sum_pass(float& m0, float& m1, float& l0,
                                               float& l1) const {
    const int n_chunks = (n + 31) / 32;
    for (int kc = 0; kc < n_chunks; ++kc) {
      const int cls = chunk_class(kc);
      if (cls == DEAD && __all_sync(0xffffffffu, m0 > -1e29f && m1 > -1e29f)) continue;
      float sc[4][4], x = -INFINITY, y = -INFINITY;
      if (cls == ZERO) {
        products(kc, sc);
        row_max(sc, x, y);
        x = fmaxf(m0, x * scale);
        y = fmaxf(m1, y * scale);
        l0 *= fast_exp2((m0 - x) * LOG2E);
        l1 *= fast_exp2((m1 - y) * LOG2E);
        m0 = x;
        m1 = y;
        exps_raw(m0, m1, sc, l0, l1);
      } else {
        scores(kc, cls, sc);
        row_max(sc, x, y);
        x = fmaxf(m0, x);
        y = fmaxf(m1, y);
        l0 *= fast_exp2((m0 - x) * LOG2E);
        l1 *= fast_exp2((m1 - y) * LOG2E);
        m0 = x;
        m1 = y;
        exps(m0, m1, sc, l0, l1);
      }
    }
    const float a = quad_max(m0), b = quad_max(m1);
    l0 = quad_sum(l0 * fast_exp2((m0 - a) * LOG2E));
    l1 = quad_sum(l1 * fast_exp2((m1 - b) * LOG2E));
    m0 = a;
    m1 = b;
  }

  // oacc += bf16(sc * (f0, f1)) . V of chunk kc
  __device__ __forceinline__ void pv(int kc, const float (&sc)[4][4], float f0, float f1,
                                     float (&oacc)[8][4]) const {
    unsigned pa[2][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      pa[nt / 2][(nt & 1) * 2 + 0] = pack2(sc[nt][0] * f0, sc[nt][1] * f0);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack2(sc[nt][2] * f1, sc[nt][3] * f1);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bf16* vp = v_lane + (kc * 32 + j * 16) * LD;
#pragma unroll
      for (int dn = 0; dn < 8; dn += 2) {
        unsigned b[4];
        ldsm_x4_t(b, vp + dn * 8);
        mma16816(oacc[dn], pa[j], b[0], b[1]);
        mma16816(oacc[dn + 1], pa[j], b[2], b[3]);
      }
    }
  }

  // over this key block: e = exp(s - m), summed into (l0, l1), and
  // oacc += bf16(e * (f0, f1)).V
  __device__ __forceinline__ void pv_pass(float m0, float m1, float f0, float f1, float& l0,
                                          float& l1, float (&oacc)[8][4]) const {
    const bool skip = MASK != NONE && rows_live(m0, m1);
    const int n_chunks = (n + 31) / 32;
    for (int kc = 0; kc < n_chunks; ++kc) {
      const int cls = chunk_class(kc);
      float sc[4][4];
      if (cls == ZERO) {
        products(kc, sc);
        exps_raw(m0, m1, sc, l0, l1);
      } else {
        if (cls == DEAD && skip) continue;
        scores(kc, cls, sc);
        exps(m0, m1, sc, l0, l1);
      }
      pv(kc, sc, f0, f1, oacc);
    }
  }

  // out = bf16(oacc), or bf16(oacc / (l0, l1)) with DIVIDE
  template <bool DIVIDE>
  __device__ __forceinline__ void store(bf16* oh, float (&oacc)[8][4], float l0,
                                        float l1) const {
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
      if (DIVIDE) {
        oacc[dn][0] = __fdiv_rn(oacc[dn][0], l0);
        oacc[dn][1] = __fdiv_rn(oacc[dn][1], l0);
        oacc[dn][2] = __fdiv_rn(oacc[dn][2], l1);
        oacc[dn][3] = __fdiv_rn(oacc[dn][3], l1);
      }
      const int c = dn * 8 + 2 * tq4;
      if (r0 < tq)
        *reinterpret_cast<__nv_bfloat162*>(oh + r0 * o_st + c) =
            __floats2bfloat162_rn(oacc[dn][0], oacc[dn][1]);
      if (r1 < tq)
        *reinterpret_cast<__nv_bfloat162*>(oh + r1 * o_st + c) =
            __floats2bfloat162_rn(oacc[dn][2], oacc[dn][3]);
    }
  }
};

// K and V rows [kb0, kb0 + n) into shared memory, zero up to a multiple of 32,
// and with a [tk] mask its clamped values into bs
template <int MASK>
__device__ __forceinline__ void load_kv(bf16* ks, bf16* vs, float* bs, const float* mask,
                                        const bf16* kh, const bf16* vh, long long st, int kb0,
                                        int n) {
  const int n32 = (n + 31) / 32 * 32;
  for (int i = threadIdx.x; i < n32 * 8; i += blockDim.x) {
    const int r = i / 8, c = (i % 8) * 8;
    const bool ok = r < n;
    const long long off = (long long)(kb0 + (ok ? r : 0)) * st + c;
    cp_async16(ks + r * LD + c, kh + off, ok);
    cp_async16(vs + r * LD + c, vh + off, ok);
  }
  cp_async_commit();
  if (MASK == KEYS)
    for (int j = threadIdx.x; j < n; j += blockDim.x) bs[j] = fmaxf(mask[kb0 + j], NEG);
  cp_async_wait<0>();
  __syncthreads();
}

template <int MASK>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2) flash_mma(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const bool one_block = p.tk <= p.block_k;
  const int sb = one_block ? p.tk : p.block_k;
  const int rows = (sb + 31) / 32 * 32;
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + (size_t)rows * LD;
  float* bs = reinterpret_cast<float*>(vs + (size_t)rows * LD);
  const int bh = blockIdx.x / p.n_qg, qg = blockIdx.x % p.n_qg;
  const int seq = bh / p.n_heads, head = bh % p.n_heads;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  const bf16* qh = p.q + seq * p.q_sb + head * p.q_sh;
  const bf16* kh = p.k + seq * p.kv_sb + head * p.kv_sh;
  const bf16* vh = p.v + seq * p.kv_sb + head * p.kv_sh;
  bf16* oh = p.o + seq * p.o_sb + head * p.o_sh;
  const int n_qt = (p.tq + 15) / 16;
  const int t_end = min(n_qt, (qg + 1) * p.tpg);
  // the TPU's zero pad keys, all in the last key block
  const int tk_p = (p.tk + p.block_k - 1) / p.block_k * p.block_k;
  const float npad = (float)(tk_p - p.tk);

  Tile<MASK> t;
  t.mask = p.mask;
  t.bs = bs;
  t.cls = p.cls;
  t.q_st = p.q_st;
  t.o_st = p.o_st;
  t.tq = p.tq;
  t.tk = p.tk;
  t.scale = p.scale;
  const int mi = lane >> 3, mr = lane & 7;
  t.k_lane = ks + mr * LD + (mi & 1) * 8 + (mi >> 1) * 16;
  t.v_lane = vs + ((mi & 1) * 8 + mr) * LD + (mi >> 1) * 8;
  float oacc[8][4];

  if (one_block) {
    // pass 1: the row max m and l = the fp32 sum of e = exp(s - m);
    // pass 2: p = bf16(e / l), out = p.V
    t.kb0 = 0;
    t.n = p.tk;
    load_kv<MASK>(ks, vs, bs, p.mask, kh, vh, p.kv_st, 0, p.tk);
    if (MASK != MATRIX) t.classify(lane, 0);  // the same chunks for every tile
    for (int qt = qg * p.tpg + warp; qt < t_end; qt += n_warps) {
      t.load_q(qh, qt * 16, lane);
      if (MASK == MATRIX) t.classify(lane, qt);
      float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
      t.max_sum_pass(m0, m1, l0, l1);
      l0 += npad * fast_exp2((NEG - m0) * LOG2E);
      l1 += npad * fast_exp2((NEG - m1) * LOG2E);
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) oacc[dn][0] = oacc[dn][1] = oacc[dn][2] = oacc[dn][3] = 0.f;
      t.pv_pass(m0, m1, __frcp_rn(l0), __frcp_rn(l1), l0, l1, oacc);
      t.template store<false>(oh, oacc, 1.f, 1.f);
    }
    return;
  }

  // several key blocks: one query tile per warp, its state kept across them
  const int qt = qg * p.tpg + warp;
  const bool active = qt < t_end;
  if (active) t.load_q(qh, qt * 16, lane);
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int dn = 0; dn < 8; ++dn) oacc[dn][0] = oacc[dn][1] = oacc[dn][2] = oacc[dn][3] = 0.f;
  for (int kb0 = 0; kb0 < p.tk; kb0 += sb) {
    const int n = min(sb, p.tk - kb0);
    __syncthreads();  // every warp is done with the previous block's K and V
    load_kv<MASK>(ks, vs, bs, p.mask, kh, vh, p.kv_st, kb0, n);
    if (!active) continue;
    t.kb0 = kb0;
    t.n = n;
    t.classify(lane, qt);
    float c0 = m0, c1 = m1;  // m_cur = max(m, this block's max)
    t.max_pass(c0, c1);
    const float corr0 = expf(m0 - c0), corr1 = expf(m1 - c1);
#pragma unroll
    for (int dn = 0; dn < 8; ++dn) {
      oacc[dn][0] *= corr0; oacc[dn][1] *= corr0;
      oacc[dn][2] *= corr1; oacc[dn][3] *= corr1;
    }
    // e = exp(s - m_cur): the block's fp32 sum, acc += bf16(e).V
    float b0 = 0.f, b1 = 0.f;
    t.pv_pass(c0, c1, 1.f, 1.f, b0, b1, oacc);
    const float pad = kb0 + sb >= p.tk ? npad : 0.f;
    b0 = quad_sum(b0) + pad * fast_exp2((NEG - c0) * LOG2E);
    b1 = quad_sum(b1) + pad * fast_exp2((NEG - c1) * LOG2E);
    l0 = __fadd_rn(__fmul_rn(l0, corr0), b0);
    l1 = __fadd_rn(__fmul_rn(l1, corr1), b1);
    m0 = c0;
    m1 = c1;
  }
  if (active) t.template store<true>(oh, oacc, l0, l1);
}

// The class map of a [tq, tk] mask: for every 16-row query tile and 32-key
// chunk, whether the clamped mask is 0 over all of it (ZERO_BIT) or -1e30
// over all of it (DEAD_BIT), rows past tq and keys past tk aside. One warp
// per (tile, chunk), one key per lane; the mask is the same for every
// (sequence, head), so this runs once per call, before flash_mma.
__global__ void __launch_bounds__(256) classify_mask(const float* mask, int tq, int tk,
                                                     unsigned char* cls) {
  const int n_ch = (tk + 31) / 32, n_qt = (tq + 15) / 16;
  const int pair = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (pair >= n_qt * n_ch) return;
  const int q0 = pair / n_ch * 16, key = pair % n_ch * 32 + lane;
  bool zero = true, dead = true;
  if (key < tk) {
    for (int r = q0; r < min(q0 + 16, tq); ++r) {
      const float b = fmaxf(mask[(long long)r * tk + key], NEG);
      zero &= b == 0.f;
      dead &= b <= NEG;
    }
  }
  zero = __all_sync(0xffffffffu, zero);
  dead = __all_sync(0xffffffffu, dead);
  if (lane == 0) cls[pair] = (zero ? ZERO_BIT : 0u) | (dead ? DEAD_BIT : 0u);
}

inline size_t smem_bytes(int tk, int block_k) {
  const int rows = (min(tk, block_k) + 31) / 32 * 32;
  return 2 * (size_t)rows * LD * sizeof(bf16) + rows * sizeof(float);
}

// Blocks per (sequence, head) and warps per block: one round of at most 8
// query tiles per block when the keys come in several softmax blocks; else
// the fewest rounds, and more blocks per head where sequences x heads would
// leave SMs idle (two blocks on each of 132).
inline void plan(int n_bh, int tq, bool one_block, int* n_qg, int* tpg, int* warps) {
  const int n_qt = (tq + 15) / 16;
  int g = one_block ? 1 : (n_qt + MAX_WARPS - 1) / MAX_WARPS;
  while ((long long)n_bh * g < 264 && g < n_qt) ++g;
  *tpg = (n_qt + g - 1) / g;
  *n_qg = (n_qt + *tpg - 1) / *tpg;
  const int rounds = (*tpg + MAX_WARPS - 1) / MAX_WARPS;
  *warps = (*tpg + rounds - 1) / rounds;
}

template <int MASK>
cudaError_t launch_mask(const Params& p, int n_bh, int warps, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.tk, p.block_k);
  cudaError_t err = cudaFuncSetAttribute(flash_mma<MASK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  flash_mma<MASK><<<n_bh * p.n_qg, warps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// mask_rows: 0 with a [tk] mask, tq with a [tq, tk] one; mask nullptr: none
inline cudaError_t launch(Params p, int n_bh, int mask_rows, cudaStream_t stream) {
  int warps;
  plan(n_bh, p.tq, p.tk <= p.block_k, &p.n_qg, &p.tpg, &warps);
  if (p.mask == nullptr) return launch_mask<NONE>(p, n_bh, warps, stream);
  if (mask_rows == 0) return launch_mask<KEYS>(p, n_bh, warps, stream);
  const int pairs = (p.tq + 15) / 16 * ((p.tk + 31) / 32);
  classify_mask<<<(pairs + 7) / 8, 256, 0, stream>>>(p.mask, p.tq, p.tk, p.cls);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_mask<MATRIX>(p, n_bh, warps, stream);
}

}  // namespace flash
}  // namespace leclip
