// Paged decode attention for Hopper (sm_90a): one query token per sequence
// over the sequence's page table -- the paper's striped page READ fused with
// attention -- split over the pages ("flash-decoding").
//
// Replaces: src/repro/kernels/paged_attention.py::paged_attention_pallas
// (its _kernel). Same contract: for each (sequence, kv-head) an f32 online
// softmax over the cached tokens for the G = H/K query heads of that
// kv-head, returning the UNNORMALISED o (B,H,D), m (B,H), l (B,H) in f32.
// A cached token (r, t) has position page_pos[b,r] + t and is valid iff
// lo <= pos < length with lo = max(0, length - window), and its page id
// (minus page_offset) lies in [0, P).
//
// What bounds it on this card: device-memory bytes and, at serving sizes,
// their latency. The work is 4*G flops per K/V element pair, about 2 flops
// per byte in bf16, far below the ~295 flops/byte where the tensor cores
// would become the limit, so no tensor cores: the only levers are bytes in
// flight and SMs kept busy. At the serving shape (8 slots, about 4 valid
// pages of 64 tokens per row, 2.6 MB of K/V) the whole read is about a
// microsecond of bandwidth, so the kernel is a chain of latencies, and the
// design keeps that chain short and wide:
//   * grid (S, K*NC, B): S splits of each (sequence, kv-head) over its pages,
//     chosen by the wrapper from static shapes only (B, K, G, R and the SM
//     count; never from lengths, which live on the device): the most splits
//     whose grid runs in one wave of two CTAs per SM (S = 4, 256 CTAs at
//     the serving shape; a fifth split put a second wave on the critical
//     path). NC chunks of the G heads keep at most 8 heads' q and
//     accumulators in registers; the padded row width W (below) is a
//     template parameter, so every per-row loop and shuffle reduction is
//     unrolled;
//   * each CTA finds its row's valid pages on the device (one warp, a ballot
//     over 32 table entries at a time: id in range, [page_pos, page_pos+T)
//     meets [lo, length)) and takes the contiguous share
//     [s*n/S, (s+1)*n/S) of those n pages -- a ring page_pos stays correct,
//     out-of-range ids (the engine's sentinel rows) are never read, and rows
//     of uneven length spread over all S CTAs of the row;
//   * K/V rows are read with 16-byte loads (N = 8 bf16 or 4 f32 a lane):
//     LPR neighbouring lanes cover one token's contiguous row, a warp covers
//     32/LPR tokens per load, and each warp keeps its next batch of rows in
//     flight (registers, double-buffered) while it computes on the current
//     one; at the serving shape one batch is a whole page, so all of a
//     share's loads are issued before the first is used;
//   * q.k is a per-lane partial dot product reduced over the row's lanes by
//     shuffles; every lane group keeps its own online softmax (m, l and its
//     slice of the accumulator) in registers, and the groups, warps and
//     splits are merged once each, at the end: shuffles within the warp,
//     shared memory across warps, and across splits the last CTA of each
//     (sequence, kv-head, head chunk) -- found by an atomic ticket after a
//     __threadfence -- merges the S partials the others left in scratch
//     (allocated by the wrapper) with online_softmax_combine's arithmetic
//     minus the final division, then resets its ticket to 0.
// Head dims: any D that is a multiple of 8 up to 128. A row is D/N 16-byte
// chunks; LPR is the next power of two at or above that (at least 16/N), so
// the padded width W = N*LPR is one of 16, 32, 64, 128 -- the only widths
// compiled. Lanes li >= D/N of a row's group load nothing and hold zeros:
// they add 0 to q.k and to o (D = 120 in bf16: 15 chunks on 16 lanes; D = 80:
// 10 on 16). The warps' partials are staged in shared memory at W; the
// split partials in scratch and the outputs are at the real D. A D that is
// its own width (16, 32, 64, 128) runs an instantiation with D a
// compile-time constant (PAD false): with D at run time in every
// instantiation the kernel took 0.0145 ms instead of 0.0129 at the
// llama3.2-1b serving shape (H100 SXM, 700 W).
// Masked scores use the finite sentinel -1e30, never -inf, and p is forced
// to 0 outside the mask, so an all-masked row (and an empty share) gives
// o=0, l=0, m=-1e30, never NaN.
// The tickets are a persistent zeroed int32 buffer that the kernel leaves
// zeroed; two launches running at once on different streams must not
// share one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Vec;  // how many T a 16-byte load holds, and how to widen them
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void widen(const uint4& u, float* x) {
    x[0] = __uint_as_float(u.x);
    x[1] = __uint_as_float(u.y);
    x[2] = __uint_as_float(u.z);
    x[3] = __uint_as_float(u.w);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void widen(const uint4& u, float* x) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is exact: the top 16 bits
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <typename KVT, int GC, int W, bool PAD>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(
    const void* __restrict__ q,          // (B, H, D) f32 or bf16 (q_bf16)
    const KVT* __restrict__ pool_k,      // (P, T, K, D)
    const KVT* __restrict__ pool_v,      // (P, T, K, D)
    const int* __restrict__ tables,      // (B, R)
    const int* __restrict__ page_pos,    // (B, R)
    const int* __restrict__ lengths,     // (B,)
    float* __restrict__ o_out,           // (B, H, D)
    float* __restrict__ m_out,           // (B, H)
    float* __restrict__ l_out,           // (B, H)
    float* __restrict__ o_part,          // (S, B, H, D) scratch, S > 1 only
    float* __restrict__ m_part,          // (S, B, H)
    float* __restrict__ l_part,          // (S, B, H)
    int* __restrict__ tickets,           // (B, K*NC), zero on entry and exit
    int q_bf16, int H, int K, int d_arg, int T, int R, int P, int window, int page_offset,
    float scale) {
  const int D = PAD ? d_arg : W;  // the row's real width
  constexpr int N = Vec<KVT>::N;  // elements a lane loads per row
  // row batches per warp in flight: q and the accumulators take 2*GC*N
  // registers a lane, the double-buffered K/V batches 16*U
  constexpr int U = GC >= 8 ? 2 : 4;
  const int S = gridDim.x;
  const int s = blockIdx.x;
  const int y = blockIdx.y;   // kv-head * NC + head chunk
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int G = H / K;
  const int NC = G / GC;
  const int kvh = y / NC;
  const int h0 = kvh * G + (y - kvh * NC) * GC;  // first query head of the chunk
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int LPR = W / N;     // lanes per token row
  constexpr int RPW = 32 / LPR;  // token rows per warp load
  static_assert(W % N == 0 && LPR <= 32 && (LPR & (LPR - 1)) == 0, "a row is 16 B times 2^k <= 32");
  const int li = lane & (LPR - 1);
  const int gi = lane / LPR;
  const bool lane_on = !PAD || li < D / N;  // this lane's 16 bytes lie inside the row

  extern __shared__ int smem_i[];
  int* pid_s = smem_i;               // R: pool page of the c-th valid page
  int* base_s = smem_i + R;          // R: its page_pos
  float* red_s = reinterpret_cast<float*>(smem_i + 2 * R);  // kWarps*GC*(W+2)
  __shared__ int n_valid_s;
  __shared__ int last_s;

  const int length = lengths[b];
  const int lo = window > 0 ? max(0, length - window) : 0;

  // q of this lane's slice of each head, pre-scaled (0 past the row)
  float qr[GC][N];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    const size_t off = ((size_t)b * H + h0 + g) * D + li * N;
#pragma unroll
    for (int e = 0; e < N; ++e)
      qr[g][e] = !lane_on ? 0.f
                 : scale * (q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[off + e])
                                   : static_cast<const float*>(q)[off + e]);
  }

  // the row's valid pages, in table order
  if (warp == 0) {
    int n = 0;
    for (int r0 = 0; r0 < R; r0 += 32) {
      const int r = r0 + lane;
      int pid = 0, base = 0;
      bool ok = false;
      if (r < R) {
        pid = tables[(size_t)b * R + r] - page_offset;
        base = page_pos[(size_t)b * R + r];
        ok = pid >= 0 && pid < P && base + T > lo && base < length;
      }
      const unsigned mask = __ballot_sync(0xffffffffu, ok);
      if (ok) {
        const int c = n + __popc(mask & ((1u << lane) - 1u));
        pid_s[c] = pid;
        base_s[c] = base;
      }
      n += __popc(mask);
    }
    if (lane == 0) n_valid_s = n;
  }
  __syncthreads();
  const int n_valid = n_valid_s;
  const int pg0 = (int)(((long long)s * n_valid) / S);
  const int pg1 = (int)(((long long)(s + 1) * n_valid) / S);
  const int n_rows = (pg1 - pg0) * T;

  float acc[GC][N], m_r[GC], l_r[GC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m_r[g] = kNegInf;
    l_r[g] = 0.f;
#pragma unroll
    for (int e = 0; e < N; ++e) acc[g][e] = 0.f;
  }

  // row i of the share: page pg0 + i / T, token i % T. A step covers
  // kWarps*RPW*U rows; warp w's batch u holds rows
  // step + (u*kWarps + w)*RPW + [0, RPW), one row per lane group.
  const int rows_per_step = kWarps * RPW * U;
  uint4 kc[U], vc[U], kn[U], vn[U];  // this step's batches, and the next step's
  int pc[U], pn[U];                  // their token positions (-1: past the share)
  auto load = [&](int step, uint4 (&kk)[U], uint4 (&vv)[U], int (&pp)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = step + (u * kWarps + warp) * RPW + gi;
      pp[u] = -1;  // a row past the share is masked like any other
      kk[u] = make_uint4(0, 0, 0, 0);
      vv[u] = make_uint4(0, 0, 0, 0);
      if (i < n_rows) {
        const int c = pg0 + i / T;
        const int t = i - (i / T) * T;
        if (lane_on) {
          const size_t off = (((size_t)pid_s[c] * T + t) * K + kvh) * D + li * N;
          kk[u] = __ldg(reinterpret_cast<const uint4*>(pool_k + off));
          vv[u] = __ldg(reinterpret_cast<const uint4*>(pool_v + off));
        }
        pp[u] = base_s[c] + t;
      }
    }
  };

  if (n_rows > 0) load(0, kc, vc, pc);
  for (int step = 0; step < n_rows; step += rows_per_step) {
    const bool more = step + rows_per_step < n_rows;
    if (more) load(step + rows_per_step, kn, vn, pn);  // in flight while this step computes
    float sc[U][GC];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[N];
      Vec<KVT>::widen(kc[u], kf);
      ok[u] = pc[u] >= lo && pc[u] < length;
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < N; ++e) d = fmaf(qr[g][e], kf[e], d);
#pragma unroll
        for (int off = LPR >> 1; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        sc[u][g] = ok[u] ? d : kNegInf;
      }
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float m_new = m_r[g];
#pragma unroll
      for (int u = 0; u < U; ++u) m_new = fmaxf(m_new, sc[u][g]);
      const float alpha = __expf(m_r[g] - m_new);
      m_r[g] = m_new;
      l_r[g] *= alpha;
#pragma unroll
      for (int e = 0; e < N; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;  // a masked token's V is never read into the sum
      float vf[N];
      Vec<KVT>::widen(vc[u], vf);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float p = __expf(sc[u][g] - m_r[g]);
        l_r[g] += p;
#pragma unroll
        for (int e = 0; e < N; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        kc[u] = kn[u];
        vc[u] = vn[u];
        pc[u] = pn[u];
      }
    }
  }

  // merge the lane groups of the warp (same li <=> same slice of D)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m_r[g], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l_r[g], off);
      const float m_new = fmaxf(m_r[g], m_o);
      const float a = __expf(m_r[g] - m_new);
      const float c = __expf(m_o - m_new);
      m_r[g] = m_new;
      l_r[g] = l_r[g] * a + l_o * c;
#pragma unroll
      for (int e = 0; e < N; ++e)
        acc[g][e] = acc[g][e] * a + __shfl_xor_sync(0xffffffffu, acc[g][e], off) * c;
    }
  }
  // then the warps, through shared memory: red_s[w][g][0..W) = o (zero
  // past D), [W] = m, [W+1] = l
  constexpr int stride = W + 2;
  if (gi == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float* r = red_s + (warp * GC + g) * stride;
#pragma unroll
      for (int e = 0; e < N; ++e) r[li * N + e] = acc[g][e];
      if (li == 0) {
        r[W] = m_r[g];
        r[W + 1] = l_r[g];
      }
    }
  }
  __syncthreads();
  const bool split = S > 1;
  for (int i = tid; i < GC * D; i += kThreads) {
    const int g = i / D;
    const int d = i - g * D;
    float m = kNegInf;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red_s[(w * GC + g) * stride + W]);
    float o = 0.f, l = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* r = red_s + (w * GC + g) * stride;
      const float a = __expf(r[W] - m);
      o = fmaf(r[d], a, o);
      l = fmaf(r[W + 1], a, l);
    }
    const size_t bh = (size_t)b * H + h0 + g;
    if (split) {
      o_part[((size_t)s * B * H + bh) * D + d] = o;
      if (d == 0) {
        m_part[(size_t)s * B * H + bh] = m;
        l_part[(size_t)s * B * H + bh] = l;
      }
    } else {
      o_out[bh * D + d] = o;
      if (d == 0) {
        m_out[bh] = m;
        l_out[bh] = l;
      }
    }
  }
  if (!split) return;

  // the last of the S CTAs of (b, y) merges the partials: a thread per 4
  // elements of (head, D) (D is a multiple of 8, so a partial row is
  // 16-byte aligned), the partials read 8 splits at a time so that
  // their loads are in flight together
  __threadfence();
  __syncthreads();
  int* ticket = tickets + (size_t)b * gridDim.y + y;
  if (tid == 0) last_s = atomicAdd(ticket, 1) == S - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  constexpr int kChunk = 8;
  const size_t split_stride = (size_t)B * H;
  for (int i = tid; i < GC * D / 4; i += kThreads) {
    const int g = 4 * i / D;
    const int d = 4 * i - g * D;
    const size_t bh = (size_t)b * H + h0 + g;
    float m = kNegInf, l = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j0 = 0; j0 < S; j0 += kChunk) {
      float mj[kChunk], lj[kChunk];
      float4 oj[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const bool in = j0 + u < S;
        const size_t at = (j0 + u) * split_stride + bh;
        mj[u] = in ? __ldcg(m_part + at) : kNegInf;
        lj[u] = in ? __ldcg(l_part + at) : 0.f;
        oj[u] = in ? __ldcg(reinterpret_cast<const float4*>(o_part + at * D + d))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float mc = m;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) mc = fmaxf(mc, mj[u]);
      const float a = __expf(m - mc);
      m = mc;
      l *= a;
      o = make_float4(o.x * a, o.y * a, o.z * a, o.w * a);
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float w = __expf(mj[u] - m);
        l = fmaf(lj[u], w, l);
        o = make_float4(fmaf(oj[u].x, w, o.x), fmaf(oj[u].y, w, o.y), fmaf(oj[u].z, w, o.z),
                        fmaf(oj[u].w, w, o.w));
      }
    }
    *reinterpret_cast<float4*>(o_out + bh * D + d) = o;
    if (d == 0) {
      m_out[bh] = m;
      l_out[bh] = l;
    }
  }
  if (tid == 0) *ticket = 0;
}

template <typename KVT, int GC, int W, bool PAD>
int launch(const void* q, int q_bf16, const void* pool_k, const void* pool_v,
           const int* tables, const int* page_pos, const int* lengths, float* o,
           float* m, float* l, float* o_part, float* m_part, float* l_part,
           int* tickets, int B, int H, int K, int D, int T, int R, int P, int window,
           int page_offset, float scale, int S, cudaStream_t stream) {
  const size_t smem = sizeof(int) * 2 * (size_t)R + sizeof(float) * kWarps * GC * (size_t)(W + 2);
  auto kernel = paged_split_kernel<KVT, GC, W, PAD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(S, K * ((H / K) / GC), B);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, static_cast<const KVT*>(pool_k), static_cast<const KVT*>(pool_v), tables,
      page_pos, lengths, o, m, l, o_part, m_part, l_part, tickets, q_bf16, H, K, D, T, R, P,
      window, page_offset, scale);
  return (int)cudaGetLastError();
}

// the padded row width W for head dim D: N = 16 / sizeof(KVT) elements a
// lane, LPR = the next power of two >= ceil(D / N) lanes, at least 16 / N
template <typename KVT>
int padded_width(int D) {
  constexpr int N = Vec<KVT>::N;
  int lanes = 16 / N;
  while (lanes * N < D) lanes *= 2;
  return lanes * N;
}

template <typename KVT>
int dispatch(int GC, int D, const void* q, int q_bf16, const void* pool_k, const void* pool_v,
             const int* tables, const int* page_pos, const int* lengths, float* o, float* m,
             float* l, float* o_part, float* m_part, float* l_part, int* tickets, int B, int H,
             int K, int T, int R, int P, int window, int page_offset, float scale, int S,
             cudaStream_t stream) {
  const int W = padded_width<KVT>(D);
#define REPRO_LAUNCH_P(C, WIDTH, PAD)                                                            \
  launch<KVT, C, WIDTH, PAD>(q, q_bf16, pool_k, pool_v, tables, page_pos, lengths, o, m, l,      \
                             o_part, m_part, l_part, tickets, B, H, K, D, T, R, P, window,       \
                             page_offset, scale, S, stream)
#define REPRO_LAUNCH(C, WIDTH) \
  if (GC == C && W == WIDTH)   \
  return D == WIDTH ? REPRO_LAUNCH_P(C, WIDTH, false) : REPRO_LAUNCH_P(C, WIDTH, true)
#define REPRO_LAUNCH_W(C) \
  REPRO_LAUNCH(C, 16);    \
  REPRO_LAUNCH(C, 32);    \
  REPRO_LAUNCH(C, 64);    \
  REPRO_LAUNCH(C, 128)
  REPRO_LAUNCH_W(1);
  REPRO_LAUNCH_W(2);
  REPRO_LAUNCH_W(4);
  REPRO_LAUNCH_W(8);
#undef REPRO_LAUNCH_W
#undef REPRO_LAUNCH
#undef REPRO_LAUNCH_P
  return -2;
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. window <= 0 means no window.
// n_splits = S (gridDim.x) and head_chunk = GC in {1, 2, 4, 8} (dividing
// H/K) come from the wrapper, from static shapes. With S > 1, o_part
// (S,B,H,D), m_part and l_part (S,B,H) are f32 scratch and tickets holds
// B*K*(H/K/GC) zeroed int32 that the launch leaves zeroed; with S == 1 they
// are not touched. D is a multiple of 8 in [8, 128].
// Returns cudaGetLastError() after the launch (0 on success), -1 for a dtype
// this file does not instantiate, -2 for a shape it does not take.
int paged_attention_fwd(const void* q, const void* pool_k, const void* pool_v,
                        const void* tables, const void* page_pos, const void* lengths,
                        void* o, void* m, void* l, void* o_part, void* m_part,
                        void* l_part, void* tickets, int B, int H, int K, int D,
                        int T, int R, int P, int window, int page_offset,
                        float scale, int q_dtype, int kv_dtype, int n_splits,
                        int head_chunk, void* stream) {
  if (q_dtype != 0 && q_dtype != 1) return -1;
  if (K <= 0 || H % K != 0 || (H / K) % head_chunk != 0 || n_splits < 1 || R < 1 || T < 1 ||
      D < 8 || D > 128 || D % 8 != 0)
    return -2;
  auto s = static_cast<cudaStream_t>(stream);
  auto tb = static_cast<const int*>(tables);
  auto pp = static_cast<const int*>(page_pos);
  auto ln = static_cast<const int*>(lengths);
  auto of = static_cast<float*>(o);
  auto mf = static_cast<float*>(m);
  auto lf = static_cast<float*>(l);
  auto op = static_cast<float*>(o_part);
  auto mp = static_cast<float*>(m_part);
  auto lp = static_cast<float*>(l_part);
  auto tk = static_cast<int*>(tickets);
  if (kv_dtype == 0)
    return dispatch<float>(head_chunk, D, q, q_dtype, pool_k, pool_v, tb, pp, ln, of, mf, lf, op,
                           mp, lp, tk, B, H, K, T, R, P, window, page_offset, scale, n_splits, s);
  if (kv_dtype == 1)
    return dispatch<__nv_bfloat16>(head_chunk, D, q, q_dtype, pool_k, pool_v, tb, pp, ln, of, mf,
                                   lf, op, mp, lp, tk, B, H, K, T, R, P, window, page_offset,
                                   scale, n_splits, s);
  return -1;
}

}  // extern "C"
