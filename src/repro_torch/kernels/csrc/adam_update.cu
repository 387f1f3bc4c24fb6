// AdamW update kernel for Hopper (sm_90a): one pass over a parameter leaf,
// or over the local workers' ZeRO-1 slices of a leaf, in one launch.
//
// Replaces no TPU kernel. The reference's update
// (src/repro/train/optimizer.py:opt_leaf_update, with clip_grads) is jnp
// element ops that XLA fuses into one loop. The port's plain update
// (train/optimizer.py:opt_leaf_update and clip_grads) runs them as ~15
// eager element kernels a slice with f32 temporaries and a blocking scalar
// copy each; on the benchmark's cells it took 14-15x the bound below.
//
// Per element, in one pass: read the parameter (bf16 or f32), the
// aggregate (bf16 or f32) and the two moments (f32 or bf16); apply the
// clip scale as clip_grads rounds it (the aggregate's dtype of
// f32(g) * scale); the AdamW update in opt_leaf_update's operation order in
// f32; write the moments back in place; then either write the parameter in
// place (a replicated leaf) or write the delta dtype(f32(new_p) - f32(p))
// in the parameter's dtype into a contiguous buffer in the
// movedim(d, 0) layout that ZeRO-1's gather takes.
//
// Arithmetic. Each operation is one IEEE round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn) in the order
// the plain path writes them: eager PyTorch rounds after every operation,
// so nothing may be contracted into an FMA. The constants are the f32
// values PyTorch's kernels use for the Python scalars (f32(1 - b1), ...);
// the step scalars (lr, 1 - b1^t, 1 - b2^t, the clip scale) come from the
// device, computed once a step by the plain path's own torch expressions.
// So the kernel equals the plain path on the card bit for bit.
//
// Bound. Device memory: per parameter the bf16 weight and aggregate read
// (4 B), the f32 moments read and written (16 B), the bf16 delta (or the
// weight) written (2 B): 22 B, 2.26 ms for granite-3-2b.d4's 344 M
// parameters and 6.61 ms for deepseek-moe-16b.d1's 1.0 B at 3.35 TB/s.
// About 50 instructions an element (three IEEE divisions and a square
// root among them), a quarter of the bytes' time at the card's rate.
//
// Design. Each operand of a slice is viewed as (outer, rows, run): the
// dims before the slice dim d, the slice dim, the dims after it, with each
// operand's own stride over `outer` (a LocalWorkers' moments are whole
// leaves narrowed by worker, a rank's are the slice itself) and the rest
// contiguous. A thread moves 8 elements a step, with 16-byte loads and
// stores where the slice's runs allow (the tile kernel's moments in two
// halves of 4: 8 bytes a half for bf16) and scalar accesses otherwise (the
// tail of a run). adam_rows_kernel walks rows of `run` elements; the
// delta's rows lie in (rows, outer) order, contiguous along the run, so
// its stores stay coalesced while run > 1. Where run == 1 and outer > 1
// (a slice of the last dim, e.g. granite's stacked w_up and wq) the delta
// is the slice transposed: adam_tile_kernel reads 64 x 64 tiles along
// the rows, stages the deltas in shared memory and writes them along
// `outer` (on the benchmark cells' leaves, the rows kernel writing the
// slice's own layout plus PyTorch's transposing copy took 36-43% longer
// a step: the copy ran at ~15% of the card's bandwidth). Both are
// grid-stride loops sized to the SMs' resident blocks, with gridDim.y one
// slice each, so all local workers' slices of a leaf take one launch.
//
// Interface: plain C, loaded with ctypes; adam_update returns the
// cudaError_t of its launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// One slice's operands (mirrored by kernels/adam_update.py:_Slice): p, g, m
// and v at the slice's first element, delta NULL for an update in place;
// the strides over `outer`, in elements. Outside the unnamed namespace:
// adam_update's C interface takes it.
struct AdamSlice {
  void* p;
  const void* g;
  void* m;
  void* v;
  void* delta;
  long long so_p, so_g, so_m, so_v;
};

namespace {

typedef __nv_bfloat16 bf16;
typedef AdamSlice Slice;

constexpr int kThreads = 256;
constexpr int kVec = 8;         // elements a thread moves a step
constexpr int kMaxSlices = 8;   // slices a launch
constexpr int kTile = 64;       // adam_tile_kernel's tile: kTile x kTile
// adam_tile_kernel's blocks an SM holds at once: 64 registers a thread,
// with the moments in two halves (no spill). At the 68-78 registers the
// compiler takes unbounded (3 blocks) it ran at 60-65% of its bound on the
// cells' leaves, at 4 blocks at 70-79%. adam_rows_kernel is left unbounded
// (59-71 registers, the moments whole): 83-85% at 3 or 4 blocks, 78-80%
// with the moments in halves.
constexpr int kTileMinBlocks = 4;


struct Args {
  Slice s[kMaxSlices];
  long long outer, rows, run;
  const float* scalars;   // lr, 1 - b1^t, 1 - b2^t, clip scale
  float b1, omb1, b2, omb2, eps, wd;
  int clip, vec, vec_out;
};

struct Step {
  float lr, bc1, bc2, scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T, as f32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// N (4 or 8) elements at p as f32, by 16- or 8-byte loads.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* o) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const float4 a = reinterpret_cast<const float4*>(p)[k];
    o[4 * k] = a.x; o[4 * k + 1] = a.y; o[4 * k + 2] = a.z; o[4 * k + 3] = a.w;
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const bf16* p, float* o) {
  uint32_t w[N / 2];
  if constexpr (N == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  }
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    o[2 * k] = __uint_as_float(w[k] << 16);
    o[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* x) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k)
    reinterpret_cast<float4*>(p)[k] =
        make_float4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
}

template <int N>
__device__ __forceinline__ void store_vec(bf16* p, const float* x) {
  if constexpr (N == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(pack2(x[0], x[1]), pack2(x[2], x[3]),
                                              pack2(x[4], x[5]), pack2(x[6], x[7]));
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(pack2(x[0], x[1]), pack2(x[2], x[3]));
}

// The first n (<= N) elements at x as f32, by vector loads where vec.
template <int N, typename T>
__device__ __forceinline__ void load_n(const T* x, int n, bool vec, float* o) {
  if (vec) {
    load_vec<N>(x, o);
    return;
  }
#pragma unroll
  for (int e = 0; e < N; ++e)
    if (e < n) o[e] = to_f(x[e]);
}

// The first n (<= N) elements of f rounded to T, stored at x.
template <int N, typename T>
__device__ __forceinline__ void store_n(T* x, int n, bool vec, const float* f) {
  if (vec) {
    store_vec<N>(x, f);
    return;
  }
#pragma unroll
  for (int e = 0; e < N; ++e)
    if (e < n) x[e] = from_f<T>(f[e]);
}

// One element: train/optimizer.py:clip_grads, then opt_leaf_update's AdamW
// branch, operation by operation. Returns f32(pf - lr * upd); m and v are
// the new moments in f32.
template <typename G>
__device__ __forceinline__ float adamw(float pf, float g, float& m, float& v,
                                       const Step& st, const Args& a) {
  if (a.clip) g = round_to<G>(__fmul_rn(g, st.scale));
  m = __fadd_rn(__fmul_rn(m, a.b1), __fmul_rn(g, a.omb1));
  v = __fadd_rn(__fmul_rn(v, a.b2), __fmul_rn(__fmul_rn(g, g), a.omb2));
  const float mh = __fdiv_rn(m, st.bc1);
  const float vh = __fdiv_rn(v, st.bc2);
  const float upd = __fadd_rn(__fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), a.eps)),
                              __fmul_rn(a.wd, pf));
  return __fsub_rn(pf, __fmul_rn(st.lr, upd));
}

// n (<= kVec) elements: loads p, g, m and v, writes the new moments back,
// and leaves the old parameter in pf and the new one, rounded to P, in np.
// The moments go in kParts parts of kVec / kParts elements: in two, fewer
// of them are live at once (the tile kernel's 64 registers).
template <int kParts, typename P, typename G, typename M>
__device__ __forceinline__ void update_chunk(const P* p, const G* g, M* m, M* v,
                                             int n, bool vec, const Step& st,
                                             const Args& a, float* pf,
                                             float* np) {
  constexpr int kPart = kVec / kParts;
  float gf[kVec];
  load_n<kVec>(p, n, vec, pf);
  load_n<kVec>(g, n, vec, gf);
#pragma unroll
  for (int h = 0; h < kParts; ++h) {
    const int nh = n - h * kPart;
    float mf[kPart], vf[kPart];
    load_n<kPart>(m + h * kPart, nh, vec, mf);
    load_n<kPart>(v + h * kPart, nh, vec, vf);
#pragma unroll
    for (int e = 0; e < kPart; ++e)
      if (vec || e < nh)
        np[h * kPart + e] = round_to<P>(
            adamw<G>(pf[h * kPart + e], gf[h * kPart + e], mf[e], vf[e], st, a));
    store_n<kPart>(m + h * kPart, nh, vec, mf);
    store_n<kPart>(v + h * kPart, nh, vec, vf);
  }
}

__device__ __forceinline__ Step load_step(const float* s) {
  return Step{s[0], s[1], s[2], s[3]};
}

// Rows of `run` contiguous elements: slice element (o, j, i) of each
// operand at o * so + j * run + i, of the delta at (j * outer + o) * run + i.
template <typename P, typename G, typename M>
__global__ void __launch_bounds__(kThreads)
adam_rows_kernel(const __grid_constant__ Args a) {
  const Slice& s = a.s[blockIdx.y];
  const Step st = load_step(a.scalars);
  P* p = static_cast<P*>(s.p);
  const G* g = static_cast<const G*>(s.g);
  M* m = static_cast<M*>(s.m);
  M* v = static_cast<M*>(s.v);
  P* delta = static_cast<P*>(s.delta);
  const long long run = a.run;
  const unsigned J = (unsigned)a.rows;
  const unsigned nrows = (unsigned)(a.outer * a.rows);
  const unsigned chunks = (unsigned)((run + kVec - 1) / kVec);
  const unsigned items = nrows * chunks;
  for (unsigned k = blockIdx.x * kThreads + threadIdx.x; k < items;
       k += gridDim.x * kThreads) {
    unsigned o = 0, j = 0, c = k;
    if (nrows > 1) {
      const unsigned row = k / chunks;
      c = k - row * chunks;
      o = row / J;
      j = row - o * J;
    }
    const long long e0 = (long long)c * kVec;
    const long long at = (long long)j * run + e0;
    const int n = (int)min((long long)kVec, run - e0);
    const bool vec = a.vec && n == kVec;
    float pf[kVec], np[kVec];
    P* pp = p + o * s.so_p + at;
    update_chunk<1, P, G, M>(pp, g + o * s.so_g + at, m + o * s.so_m + at,
                          v + o * s.so_v + at, n, vec, st, a, pf, np);
    if (delta == nullptr) {
      store_n<kVec>(pp, n, vec, np);
    } else {
      float d[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) d[e] = __fsub_rn(np[e], pf[e]);
      store_n<kVec>(delta + ((long long)j * a.outer + o) * run + e0, n, vec, d);
    }
  }
}

// run == 1, outer > 1: slice element (o, j) of each operand at o * so + j,
// of the delta at j * outer + o. A tile's 64 rows o are read along j (8
// threads a row, 8 elements each), its deltas staged in shared memory
// and written along o.
template <typename P, typename G, typename M>
__global__ void __launch_bounds__(kThreads, kTileMinBlocks)
adam_tile_kernel(const __grid_constant__ Args a) {
  __shared__ float tile[kTile][kTile + 1];   // [j][o], rounded to P
  const Slice& s = a.s[blockIdx.y];
  const Step st = load_step(a.scalars);
  const P* p = static_cast<const P*>(s.p);
  const G* g = static_cast<const G*>(s.g);
  M* m = static_cast<M*>(s.m);
  M* v = static_cast<M*>(s.v);
  P* delta = static_cast<P*>(s.delta);
  const long long O = a.outer, J = a.rows;
  const unsigned tj = (unsigned)((J + kTile - 1) / kTile);
  const unsigned tiles = (unsigned)((O + kTile - 1) / kTile) * tj;
  const int c = threadIdx.x % (kTile / kVec);
  const int r = threadIdx.x / (kTile / kVec);
  constexpr int kRowsAPass = kThreads / (kTile / kVec);
  for (unsigned t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long o0 = (long long)(t / tj) * kTile;
    const long long j0 = (long long)(t % tj) * kTile;
#pragma unroll 1
    for (int h = 0; h < kTile / kRowsAPass; ++h) {
      const int ol = r + kRowsAPass * h;
      const long long o = o0 + ol, j = j0 + c * kVec;
      if (o < O && j < J) {
        const int n = (int)min((long long)kVec, J - j);
        float pf[kVec], np[kVec];
        update_chunk<2, P, G, M>(p + o * s.so_p + j, g + o * s.so_g + j,
                              m + o * s.so_m + j, v + o * s.so_v + j, n,
                              a.vec && n == kVec, st, a, pf, np);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          if (e < n) tile[c * kVec + e][ol] = round_to<P>(__fsub_rn(np[e], pf[e]));
      }
    }
    __syncthreads();
#pragma unroll 1
    for (int h = 0; h < kTile / kRowsAPass; ++h) {
      const int jl = r + kRowsAPass * h;
      const long long j = j0 + jl, o = o0 + c * kVec;
      if (j < J && o < O) {
        const int n = (int)min((long long)kVec, O - o);
        float d[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          if (e < n) d[e] = tile[jl][c * kVec + e];
        store_n<kVec>(delta + j * O + o, n, a.vec_out && n == kVec, d);
      }
    }
    __syncthreads();
  }
}

template <typename P, typename G, typename M>
const void* kernel_of(bool tile) {
  return tile ? (const void*)adam_tile_kernel<P, G, M>
              : (const void*)adam_rows_kernel<P, G, M>;
}

// Blocks of the kernel one SM holds at once, or a negative cudaError_t.
inline int occupancy(const void* fn) {
  int blocks = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, 0);
  return err == cudaSuccess ? blocks : -(int)err;
}

template <typename P, typename G, typename M>
int launch(const Args& a, int n, cudaStream_t stream) {
  const bool tile = a.outer > 1 && a.run == 1;
  static int occ[2] = {0, 0};
  if (occ[tile] <= 0) {
    occ[tile] = occupancy(kernel_of<P, G, M>(tile));
    if (occ[tile] < 0) return -occ[tile];
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  long long work;
  if (tile)
    work = ((a.outer + kTile - 1) / kTile) * ((a.rows + kTile - 1) / kTile);
  else
    work = (a.outer * a.rows * ((a.run + kVec - 1) / kVec) + kThreads - 1) /
           kThreads;
  if (work == 0) return 0;
  long long per = (long long)sms * occ[tile] / n;
  if (per < 1) per = 1;
  const dim3 grid((unsigned)(work < per ? work : per), (unsigned)n);
  if (tile)
    adam_tile_kernel<P, G, M><<<grid, kThreads, 0, stream>>>(a);
  else
    adam_rows_kernel<P, G, M><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename P, typename G>
int by_m(int m_bf16, const Args& a, int n, cudaStream_t st) {
  return m_bf16 ? launch<P, G, bf16>(a, n, st) : launch<P, G, float>(a, n, st);
}

template <typename P>
int by_g(int g_bf16, int m_bf16, const Args& a, int n, cudaStream_t st) {
  return g_bf16 ? by_m<P, bf16>(m_bf16, a, n, st) : by_m<P, float>(m_bf16, a, n, st);
}

}  // namespace

extern "C" {

// Slices a launch: adam_update launches once a kMaxSlices of them.
int adam_update_max_slices() { return kMaxSlices; }

// Blocks of the tile (tile != 0) or rows kernel one SM of the current
// device holds at once for these dtypes, or a negative cudaError_t.
int adam_update_occupancy(int tile, int p_bf16, int g_bf16, int m_bf16) {
  const void* fn;
  if (p_bf16)
    fn = g_bf16 ? (m_bf16 ? kernel_of<bf16, bf16, bf16>(tile) : kernel_of<bf16, bf16, float>(tile))
                : (m_bf16 ? kernel_of<bf16, float, bf16>(tile) : kernel_of<bf16, float, float>(tile));
  else
    fn = g_bf16 ? (m_bf16 ? kernel_of<float, bf16, bf16>(tile) : kernel_of<float, bf16, float>(tile))
                : (m_bf16 ? kernel_of<float, float, bf16>(tile) : kernel_of<float, float, float>(tile));
  return occupancy(fn);
}

// The AdamW update of n_slices slices of one geometry (outer, rows, run);
// dtypes bf16 where the flag is set, else f32 (m and v share one). vec:
// every operand's runs start on 16 bytes; vec_out: the tile kernel's
// delta rows do.
int adam_update(const AdamSlice* slices, int n_slices, long long outer,
                long long rows, long long run, const float* scalars, float b1,
                float omb1, float b2, float omb2, float eps, float wd, int clip,
                int p_bf16, int g_bf16, int m_bf16, int vec, int vec_out,
                void* stream) {
  Args a;
  a.outer = outer;
  a.rows = rows;
  a.run = run;
  a.scalars = scalars;
  a.b1 = b1;
  a.omb1 = omb1;
  a.b2 = b2;
  a.omb2 = omb2;
  a.eps = eps;
  a.wd = wd;
  a.clip = clip;
  a.vec = vec;
  a.vec_out = vec_out;
  cudaStream_t st = (cudaStream_t)stream;
  for (int first = 0; first < n_slices; first += kMaxSlices) {
    const int n = n_slices - first < kMaxSlices ? n_slices - first : kMaxSlices;
    for (int i = 0; i < n; ++i) a.s[i] = slices[first + i];
    const int err = p_bf16 ? by_g<bf16>(g_bf16, m_bf16, a, n, st)
                           : by_g<float>(g_bf16, m_bf16, a, n, st);
    if (err) return err;
  }
  return 0;
}

}  // extern "C"
