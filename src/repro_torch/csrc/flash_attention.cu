// Flash attention forward for Hopper (sm_90a): causal / sliding-window /
// non-causal cross attention with GQA, for prefill.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (its _kernel). Same contract: q (B,Sq,H,D), k/v (B,Sk,K,D), query head h
// reads kv head h*K/H, query row i sits at absolute position q_start + i,
// a key at position j is kept iff (!causal || j <= qpos) and
// (no window || j > qpos - window); softmax is online in f32 and p is kept
// to f32 accuracy in the P.V product; the output is acc / max(l, 1e-30) in
// q's dtype. The TPU's sequential nk grid axis becomes a loop inside the CTA
// over 64-key tiles; it starts at the first tile the window can reach and,
// for causal attention, stops at the diagonal, so fully masked tiles are
// never read. Only the edge tiles (the diagonal, the window's start, the
// ragged end of the keys) are masked. There is no divisibility
// requirement: rows past Sq and keys past Sk are masked, so any prompt
// length works (the TPU wrapper asserts Sq % block_q == 0).
//
// What bounds it on this card: at the prefill shapes of llama3.2-1b
// (B = 1, Sq = Sk = 192, H = 32, K = 8, D = 64) the work is ~0.15 GFLOP
// against ~2 MB of q/k/v/out -- 0.15 us of bf16 tensor-core time, 0.6 us of
// bytes -- so the kernel is bound by latency: the chain of loads and
// dependent products of at most 3 key tiles, and the launch. Two paths:
//
// bf16 (flash_fwd_tc_kernel): tensor cores. A warp owns 16 query rows of
// one head; a CTA packs HP warps = HP query heads of ONE kv-head (the
// largest HP <= 4 dividing G), so each K/V tile is staged once for HP heads.
// At the llama3.2-1b prefill shape that is 96 CTAs of 4 warps, fewer than
// the 132 SMs, and measured faster than 192 CTAs of 2 warps or 384 of 1:
// the kernel waits on latency, not on SMs, and fewer CTAs stage fewer
// copies of each tile. Q and the K/V tiles go to shared memory with
// 16-byte cp.async (zero-filled past Sq/Sk), into a 3-stage ring of K/V
// tiles: up to 3 tiles are in flight at once, so at Sk <= 192 every load
// of the CTA is issued before the first product; rows are padded to D+8 bf16 so that
// ldmatrix reads them without bank conflicts. Q's fragments are loaded into
// registers once (ldmatrix). S = Q K^T runs on
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32: the products of bf16 inputs
// are exact and accumulate in f32, as the reference's f32 dot product. The
// online softmax stays in registers (row max and sum over the quad by
// shuffles, exp2 with the scale folded into log2 units). The S accumulator
// fragments become P's A fragments in place (no round trip through shared
// memory), and p keeps f32 accuracy in P.V by a hi/lo split into two bf16
// (p = hi + lo to ~2^-16 relative), each multiplied by V (ldmatrix.trans)
// on the tensor cores into the f32 accumulator.
//
// Head dims: any D that is a multiple of 8 up to 128 (a row is whole 16-byte
// chunks). The bf16 kernel is compiled for the padded widths DP = 16, 32,
// 64, 128 and takes the real D at run time: it stages DP columns of q, k
// and v in shared memory, the columns [D, DP) zero-filled by cp.async with
// a source size of 0 (no branch, no read), so they add 0 to Q K^T and give
// 0 in O, and it writes back only the D real columns. D = 120 runs at DP =
// 128; D = 80 at DP = 128 (37.5% of its products are on zeros). A D equal
// to its DP runs an instantiation with D a compile-time constant (PAD
// false), which keeps the bounds checks and index products out of it.
//
// f32 (flash_fwd_f32_kernel): the CUDA-core loop, f32 FMA throughout; its
// 2e-5 tolerance rules out TF32 and bf16 tensor cores. One CTA per
// (16-row q-block, head, batch row); tiles staged in shared memory, K rows
// padded to D+1 floats so the score loop hits distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBQ = 16;  // query rows per CTA
constexpr int kBK = 64;  // keys per tile

__device__ __forceinline__ bool keep(int qpos, int kpos, int Sk, int causal, int window) {
  return kpos < Sk && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

// ------------------------------ f32: CUDA cores ------------------------------
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(
    const float* __restrict__ q,   // (B, Sq, H, D)
    const float* __restrict__ k,   // (B, Sk, K, D)
    const float* __restrict__ v,   // (B, Sk, K, D)
    float* __restrict__ out,       // (B, Sq, H, D)
    int Sq, int Sk, int H, int K, int D, int causal, int window, int q_start,
    float scale) {
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h * K / H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;                    // BQ*D
  float* k_s = q_s + kBQ * D;           // BK*(D+1), rows padded
  float* v_s = k_s + kBK * (D + 1);     // BK*D
  float* p_s = v_s + kBK * D;           // BQ*BK scores, then probabilities
  float* acc_s = p_s + kBQ * kBK;       // BQ*D
  float* m_s = acc_s + kBQ * D;         // BQ
  float* l_s = m_s + kBQ;               // BQ
  float* alpha_s = l_s + kBQ;           // BQ

  for (int i = tid; i < kBQ * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i - r * D;
    const int row = q0 + r;
    q_s[i] = row < Sq ? q[(((size_t)b * Sq + row) * H + h) * D + d] : 0.f;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < kBQ; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int last_row = min(q0 + kBQ, Sq) - 1;
  const int qpos_lo = q_start + q0;
  const int qpos_hi = q_start + last_row;
  int k_end = Sk;
  if (causal) k_end = min(Sk, qpos_hi + 1);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, qpos_lo - window + 1) / kBK * kBK;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    for (int i = tid; i < kBK * D; i += blockDim.x) {
      const int j = i / D;
      const int d = i - j * D;
      const int key = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (key < Sk) {
        const size_t off = (((size_t)b * Sk + key) * K + kvh) * D + d;
        kx = k[off];
        vx = v[off];
      }
      k_s[j * (D + 1) + d] = kx;
      v_s[i] = vx;
    }
    __syncthreads();

    for (int i = tid; i < kBQ * kBK; i += blockDim.x) {
      const int r = i / kBK;
      const int j = i - r * kBK;
      const float* qr = q_s + r * D;
      const float* kj = k_s + j * (D + 1);
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kj[d], dot);
      p_s[i] = keep(q_start + q0 + r, k0 + j, Sk, causal, window) ? dot * scale : kNegInf;
    }
    __syncthreads();

    for (int r = warp; r < kBQ; r += n_warps) {
      const int qpos = q_start + q0 + r;
      float mx = kNegInf;
      for (int j = lane; j < kBK; j += 32) mx = fmaxf(mx, p_s[r * kBK + j]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < kBK; j += 32) {
        const float p = keep(qpos, k0 + j, Sk, causal, window)
                            ? expf(p_s[r * kBK + j] - m_new) : 0.f;
        p_s[r * kBK + j] = p;
        sum += p;
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {  // every lane read m_prev before the shuffles above
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < kBQ * D; i += blockDim.x) {
      const int r = i / D;
      const int d = i - r * D;
      const float* pr = p_s + r * kBK;
      float pv = 0.f;
      for (int j = 0; j < kBK; ++j) pv = fmaf(pr[j], v_s[j * D + d], pv);
      acc_s[i] = acc_s[i] * alpha_s[r] + pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < kBQ * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i - r * D;
    const int row = q0 + r;
    if (row < Sq)
      out[(((size_t)b * Sq + row) * H + h) * D + d] = acc_s[i] / fmaxf(l_s[r], 1e-30f);
  }
}

// ----------------------------- bf16: tensor cores -----------------------------
constexpr int kTcBQ = 16;       // query rows per warp: the mma's M
constexpr int kTcBK = 64;       // keys per tile
constexpr int kTcMaxHeads = 4;  // warps (query heads) per CTA
constexpr int kTcStages = 3;    // K/V tiles in flight: all of them at Sk <= 192

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronously; zero-fills when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}
// (x0, x1) = hi + lo with hi, lo bf16 pairs (x0 in the low half, the mma's
// lower column)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

template <int DP, bool PAD>
__global__ void __launch_bounds__(kTcMaxHeads * 32) flash_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q,  // (B, Sq, H, D)
    const __nv_bfloat16* __restrict__ k,  // (B, Sk, K, D)
    const __nv_bfloat16* __restrict__ v,  // (B, Sk, K, D)
    __nv_bfloat16* __restrict__ out,      // (B, Sq, H, D)
    int Sq, int Sk, int H, int K, int d_arg, int causal, int window, int q_start,
    float scale_log2) {
  constexpr int BQ = kTcBQ, BK = kTcBK;
  constexpr int LD = DP + 8;    // shared row stride in bf16: conflict-free ldmatrix
  constexpr int CH = DP / 8;    // 16-byte chunks per staged row
  constexpr int NKS = DP / 16;  // k-steps of S = Q K^T over the head dim
  constexpr int NST = BK / 8;   // n-tiles of S over the keys
  constexpr int NDT = DP / 8;   // n-tiles of O over the head dim
  const int D = PAD ? d_arg : DP;  // the row's real width
  const int ch = D / 8;            // chunks that lie inside a row: the rest are zero
  const int HP = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * BQ;
  const int h_first = blockIdx.y * HP;
  const int h = h_first + warp;
  const int b = blockIdx.z;
  const int kvh = h_first / (H / K);  // HP | G: every head of the CTA reads it

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // HP x BQ x LD
  __nv_bfloat16* k_s = q_s + HP * BQ * LD;                            // kTcStages x BK x LD
  __nv_bfloat16* v_s = k_s + kTcStages * BK * LD;                     // kTcStages x BK x LD

  const int last_row = min(q0 + BQ, Sq) - 1;
  const int qlo = q_start + q0;
  const int qhi = q_start + last_row;
  const int k_end = causal ? min(Sk, qhi + 1) : Sk;
  const int k_begin = window > 0 ? max(0, qlo - window + 1) / BK * BK : 0;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  for (int i = threadIdx.x; i < HP * BQ * CH; i += blockDim.x) {
    const int c = i % CH;
    const int r = (i / CH) % BQ;
    const int hp = i / (CH * BQ);
    const int row = q0 + r;
    const bool ok = row < Sq && (!PAD || c < ch);
    const size_t off = (((size_t)b * Sq + (ok ? row : 0)) * H + h_first + hp) * D;
    cp_async16(q_s + (hp * BQ + r) * LD + c * 8, q + off + (ok ? c * 8 : 0), ok);
  }
  auto load_kv = [&](int tile) {
    const int k0 = k_begin + tile * BK;
    __nv_bfloat16* ks = k_s + (tile % kTcStages) * BK * LD;
    __nv_bfloat16* vs = v_s + (tile % kTcStages) * BK * LD;
    for (int i = threadIdx.x; i < BK * CH; i += blockDim.x) {
      const int c = i % CH;
      const int j = i / CH;
      const int key = k0 + j;
      const bool ok = key < Sk && (!PAD || c < ch);
      const size_t off = (((size_t)b * Sk + (ok ? key : 0)) * K + kvh) * D + (ok ? c * 8 : 0);
      cp_async16(ks + j * LD + c * 8, k + off, ok);
      cp_async16(vs + j * LD + c * 8, v + off, ok);
    }
  };
  // group 0: Q and tile 0; group 1: tile 1; then one group per iteration
  // (tile it + 2, issued as soon as its stage is free)
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();
  if (n_tiles > 1) load_kv(1);
  cp_async_commit();
  static_assert(kTcStages == 3, "the prologue and the loop keep 3 groups in flight");

  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // thread in the quad: columns 2t, 2t+1
  const int mat = lane >> 3;  // which 8x8 matrix this lane addresses in ldmatrix.x4
  uint32_t qf[NKS][4];
  float o_acc[NDT][4];
#pragma unroll
  for (int j = 0; j < NDT; ++j) o_acc[j][0] = o_acc[j][1] = o_acc[j][2] = o_acc[j][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};  // rows g and g + 8, log2 units
  float l_r[2] = {0.f, 0.f};          // this thread's partial row sums

  for (int it = 0; it < n_tiles; ++it) {
    __syncthreads();  // every warp is done with tile it - 1: its stage is free
    if (it + 2 < n_tiles) load_kv(it + 2);
    cp_async_commit();
    cp_async_wait<2>();  // all but the 2 newest groups: tile it (and Q) landed
    __syncthreads();
    if (it == 0) {
      const __nv_bfloat16* qw = q_s + warp * BQ * LD;
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk)
        ldmatrix_x4(qf[kk], qw + ((mat & 1) * 8 + (lane & 7)) * LD + kk * 16 + (mat >> 1) * 8);
    }
    const __nv_bfloat16* ks = k_s + (it % kTcStages) * BK * LD;
    const __nv_bfloat16* vs = v_s + (it % kTcStages) * BK * LD;
    const int k0 = k_begin + it * BK;

    float sc[NST][4];
#pragma unroll
    for (int j = 0; j < NST; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NKS; ++kk) {
#pragma unroll
      for (int np = 0; np < NST / 2; ++np) {
        uint32_t r[4];  // K rows np*16 + [0,8) and + [8,16), columns kk*16 + [0,16)
        ldmatrix_x4(r, ks + (np * 16 + (mat >> 1) * 8 + (lane & 7)) * LD + kk * 16 + (mat & 1) * 8);
        mma_bf16(sc[2 * np], qf[kk], r[0], r[1]);
        mma_bf16(sc[2 * np + 1], qf[kk], r[2], r[3]);
      }
    }

    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > qlo) ||
                      (window > 0 && k0 <= qhi - window);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < NST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale_log2;
        if (edge && !keep(q_start + q0 + g + (e >> 1) * 8, k0 + j * 8 + 2 * t + (e & 1), Sk,
                          causal, window))
          x = kNegInf;
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float alpha = exp2f(m_r[i] - mx[i]);
      m_r[i] = mx[i];
      l_r[i] *= alpha;
#pragma unroll
      for (int j = 0; j < NDT; ++j) {
        o_acc[j][2 * i] *= alpha;
        o_acc[j][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = sc[j][e] == kNegInf ? 0.f : exp2f(sc[j][e] - m_r[e >> 1]);
        sc[j][e] = p;
        l_r[e >> 1] += p;
      }
    }

    // O += P V: S's C fragments of keys kk*16 + [0,16) are P's A fragment
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(sc[2 * kk][0], sc[2 * kk][1], hi[0], lo[0]);
      split_bf16(sc[2 * kk][2], sc[2 * kk][3], hi[1], lo[1]);
      split_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int dp = 0; dp < NDT / 2; ++dp) {
        uint32_t r[4];  // V rows kk*16 + [0,16), columns dp*16 + [0,8) and + [8,16)
        ldmatrix_x4_trans(r, vs + (kk * 16 + (mat & 1) * 8 + (lane & 7)) * LD + dp * 16 +
                                 (mat >> 1) * 8);
        mma_bf16(o_acc[2 * dp], hi, r[0], r[1]);
        mma_bf16(o_acc[2 * dp], lo, r[0], r[1]);
        mma_bf16(o_acc[2 * dp + 1], hi, r[2], r[3]);
        mma_bf16(o_acc[2 * dp + 1], lo, r[2], r[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const int row = q0 + g + i * 8;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = out + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NDT; ++j)
      if (!PAD || j < ch)  // n-tile j is columns j*8 + [0, 8): the real ones only
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t) =
            __floats2bfloat162_rn(o_acc[j][2 * i] * inv, o_acc[j][2 * i + 1] * inv);
  }
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int launch_f32(const float* q, const float* k, const float* v, float* out, int B, int Sq, int Sk,
               int H, int K, int D, int causal, int window, int q_start, float scale,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * kBQ * D + (size_t)kBK * (D + 1) +
                                       (size_t)kBK * D + (size_t)kBQ * kBK + 3 * kBQ);
  if (int err = set_smem((const void*)flash_fwd_f32_kernel, smem)) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_f32_kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, Sq, Sk, H, K, D, causal,
                                                         window, q_start, scale);
  return (int)cudaGetLastError();
}

template <int DP, bool PAD>
int launch_tc(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
              __nv_bfloat16* out, int B, int Sq, int Sk, int H, int K, int D, int causal,
              int window, int q_start, float scale, int heads, cudaStream_t stream) {
  const size_t smem =
      sizeof(__nv_bfloat16) * (DP + 8) * ((size_t)heads * kTcBQ + 2 * kTcStages * kTcBK);
  if (int err = set_smem((const void*)flash_fwd_tc_kernel<DP, PAD>, smem)) return err;
  const dim3 grid((Sq + kTcBQ - 1) / kTcBQ, H / heads, B);
  flash_fwd_tc_kernel<DP, PAD><<<grid, 32 * heads, smem, stream>>>(
      q, k, v, out, Sq, Sk, H, K, D, causal, window, q_start, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// window <= 0 means no window. heads_per_cta (bf16 only): query heads of one
// kv-head per CTA, in {1, 2, 4} and dividing H/K. D is a multiple of 8 in
// [8, 128]. Returns cudaGetLastError() after the launch (0 on success), -1
// for a dtype this file does not instantiate, -2 for a shape it does not
// take.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                        int B, int Sq, int Sk, int H, int K, int D, int causal,
                        int window, int q_start, float scale, int dtype,
                        int heads_per_cta, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (B < 1 || Sq < 1 || K < 1 || H % K != 0 || D < 8 || D > 128 || D % 8 != 0) return -2;
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                      static_cast<const float*>(v), static_cast<float*>(out), B, Sq, Sk, H, K, D,
                      causal, window, q_start, scale, s);
  if (dtype != 1) return -1;
  const int hp = heads_per_cta;
  if ((hp != 1 && hp != 2 && hp != 4) || (H / K) % hp != 0) return -2;
  auto qb = static_cast<const __nv_bfloat16*>(q);
  auto kb = static_cast<const __nv_bfloat16*>(k);
  auto vb = static_cast<const __nv_bfloat16*>(v);
  auto ob = static_cast<__nv_bfloat16*>(out);
#define REPRO_LAUNCH(DP)                                                                          \
  return D == DP ? launch_tc<DP, false>(qb, kb, vb, ob, B, Sq, Sk, H, K, D, causal, window, q_start, \
                                        scale, hp, s)                                              \
                 : launch_tc<DP, true>(qb, kb, vb, ob, B, Sq, Sk, H, K, D, causal, window, q_start,  \
                                       scale, hp, s)
  if (D <= 16) REPRO_LAUNCH(16);
  if (D <= 32) REPRO_LAUNCH(32);
  if (D <= 64) REPRO_LAUNCH(64);
  REPRO_LAUNCH(128);
#undef REPRO_LAUNCH
}

}  // extern "C"
