// Flash attention forward for Hopper (sm_90a): causal / sliding-window /
// non-causal cross attention with GQA, for prefill.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (its _kernel). Same contract: q (B,Sq,H,D), k/v (B,Sk,K,D), query head h
// reads kv head h*K/H, query row i sits at absolute position q_start + i,
// a key at position j is kept iff (!causal || j <= qpos) and
// (no window || j > qpos - window); softmax is online in f32 and p stays
// f32 in the P.V product; the output is acc / max(l, 1e-30) in q's dtype.
//
// Grid (ceil(Sq/BQ), H, B): one CTA per (q-block, head, batch row). The
// TPU's sequential nk grid axis becomes a loop inside the CTA over BK-key
// tiles; it starts at the first tile the window can reach and, for causal
// attention, stops at the diagonal, so fully masked tiles are never read.
// There is no divisibility requirement: rows past Sq and keys past Sk are
// masked, so any prompt length works (the TPU wrapper asserts
// Sq % block_q == 0).
//
// What bounds it on this card: at the prefill shapes of llama3.2-1b
// (Sq = Sk = 192, H = 32, D = 64) the work is ~0.15 GFLOP against ~2 MB of
// q/k/v/out, so the bf16 tensor cores would finish in a fraction of the time
// the bytes take; the real limit of this simple version is its f32 FMA loop
// on the CUDA cores (no wgmma), which keeps p in f32 as the reference does.
// Tiles are staged in shared memory as f32; K rows are padded to D+1 floats
// so the score loop (neighbouring threads on neighbouring keys) hits
// distinct banks, and q rows are read as broadcasts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBQ = 16;  // query rows per CTA
constexpr int kBK = 64;  // keys per tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ bool keep(int qpos, int kpos, int Sk, int causal, int window) {
  return kpos < Sk && (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q,   // (B, Sq, H, D)
    const T* __restrict__ k,   // (B, Sk, K, D)
    const T* __restrict__ v,   // (B, Sk, K, D)
    T* __restrict__ out,       // (B, Sq, H, D)
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
    q_s[i] = row < Sq ? to_f32(q[(((size_t)b * Sq + row) * H + h) * D + d]) : 0.f;
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
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
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
      store(&out[(((size_t)b * Sq + row) * H + h) * D + d], acc_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
           int Sk, int H, int K, int D, int causal, int window, int q_start,
           float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * kBQ * D + (size_t)kBK * (D + 1) +
                                       (size_t)kBK * D + (size_t)kBQ * kBK + 3 * kBQ);
  auto kernel = flash_fwd_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), Sq, Sk, H, K, D, causal, window, q_start, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// window <= 0 means no window. Returns cudaGetLastError() after the launch
// (0 on success), or -1 for a dtype this file does not instantiate.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                        int B, int Sq, int Sk, int H, int K, int D, int causal,
                        int window, int q_start, float scale, int dtype,
                        void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, Sq, Sk, H, K, D, causal, window, q_start, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, K, D, causal, window, q_start,
                                 scale, s);
  return -1;
}

}  // extern "C"
