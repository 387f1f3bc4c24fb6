// Fused wire-codec kernels for Hopper (sm_90a): the producer and the
// consumer of the compressed gradient wire, one CUDA block per sketch
// block.
//
// Producer, wire_encode_kernel, replaces the TPU kernel
// src/repro/kernels/sketch_wire.py:encode_pack_quantize_pallas (body
// _wire_encode_kernel). One pass over the gradient block: Count-Sketch
// encode, non-zero bitmap pack, per-block max|sketch|. Its quantize leg
// (TS = int, body _wire_encode_q_kernel) stores the fxp32 wire's
// int32(rint(acc * 2^(M - e))) for the block's exponent e instead of the
// f32 cell; maxabs stays the f32 max|acc|.
//
// Consumer, wire_peel_kernel, replaces
// src/repro/kernels/sketch_wire.py:dequant_peel_unpack_pallas (body
// _wire_peel_kernel). One pass over the aggregated wire payload: bitmap
// unpack, initial degrees, exactly `rounds` synchronous peel rounds, and
// the median-of-3 estimate for bits still set. Its dequant leg (TS = int,
// body _wire_peel_dq_kernel) loads the int32 aggregate as
// float(q) * 2^(e - M) where the f32 leg loads y.
//
// The legs' scales are exact powers of two written into the exponent
// field (pow2f), never exp2f/ldexpf, and the conversions round half to
// even (__float2int_rn, __int2float_rn), as rint and the int-to-float
// cast do: the quantize leg equals "f32 leg, then FixedPointWire.encode"
// and the dequant leg "FixedPointWire.decode, then f32 leg" bit for bit
// on any input. Each adds one multiply and one conversion per sketch
// cell and 4 bytes of exponent per block, so the bounds below hold.
//
// Bound. Both are bound by device memory. Per block of G*c elements the
// producer reads the block (4Gc bytes) and writes the sketch, the words
// and one float (4*rows*c + Gc/8 + 4 bytes): 139 KB at G=60, c=512,
// rows=6. The consumer reads the sketch and the words and writes values
// and an int8 residual (5Gc bytes): 170 KB. The arithmetic is ~3Gc adds
// per pass, about 100 times below the bytes at the card's rates.
//
// Design. Each block keeps everything it touches more than once in shared
// memory, so device memory sees each input byte once and each output byte
// once: the producer stages the x block (120 KiB) and reads it three
// times from there; the consumer keeps y, the degrees, the bits and the
// plane of peeled values (~152 KiB) resident across all rounds. A
// geometry whose state does not fit the card's shared memory (the
// lossless profile, rows=60 at ratio 2: ~311 KiB for the consumer) runs
// the same code with that state in device memory instead: x read where it
// lies, y and the degrees in scratch planes, peeled values read back from
// the output. Only the bits and rotations stay in shared memory. Every
// sketch cell (r, m) is owned by one thread, which sums its contributions
// in the reference's (i, j) order from 0.0 using a per-row list of the
// (i, j) pairs that hash to row r. There are no float atomics, so a run
// repeats bit for bit, and on dyadic inputs the result equals the plain
// version's exactly. The bitmap word w, bit k is element 32w+k of the
// block: one __ballot_sync per warp over 32 consecutive elements.
//
// The TPU kernels' one-hot plan-matrix contraction, VMEM budgets and
// multi-block grid cells are not carried over. Several blocks per CUDA
// block, cp.async/TMA staging and a warp-specialised peel are later work.
//
// Interface: plain C, loaded with ctypes. Each function returns the
// cudaError_t of the launch (0 on success). Words are uint32 bits (the
// PyTorch side stores them in int32 tensors).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// rot[3i + j] = rot_j(i, blk), as src/repro/core/hashing.py:block_rotations.
__device__ void block_rotations(int* rot, uint32_t blk, int group, int lanes,
                                uint32_t salt) {
  for (int t = threadIdx.x; t < group * 3; t += blockDim.x) {
    uint32_t key = blk * 0x01000193u + (uint32_t)t + salt;
    rot[t] = (int)(mix32(key) % (uint32_t)lanes);
  }
}

// Exact float 2^k for k in [-126, 127] (net/fixedpoint.py:pow2).
__device__ __forceinline__ float pow2f(int k) {
  return __int_as_float((k + 127) << 23);
}

// A sketch cell as the wire carries it: f32, or the fxp32 int32 at the
// block's scale s (2^(M-e) to store, 2^(e-M) to load).
__device__ __forceinline__ void store_cell(float* p, float acc, float) {
  *p = acc;
}
__device__ __forceinline__ void store_cell(int* p, float acc, float s) {
  *p = __float2int_rn(acc * s);
}
__device__ __forceinline__ float load_cell(const float* p, float) {
  return *p;
}
__device__ __forceinline__ float load_cell(const int* p, float s) {
  return __int2float_rn(*p) * s;
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? scratch[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// Shared-memory layout of the producer: x block (when kResident), then
// rotations. TS is the sketch's wire type: float, or int for the
// quantize leg (exps and mbits are read only then).
template <bool kResident, typename TS>
__global__ void __launch_bounds__(kThreads)
wire_encode_kernel(const float* __restrict__ x, const int* __restrict__ ids,
                   const int* __restrict__ row_ptr,
                   const int* __restrict__ ent,
                   const float* __restrict__ ent_sign,
                   TS* __restrict__ sketch, uint32_t* __restrict__ words,
                   float* __restrict__ maxabs,
                   const int* __restrict__ exps, int mbits, int group,
                   int lanes, int rows, uint32_t salt) {
  extern __shared__ float smem[];
  __shared__ float warp_max[kThreads / 32];
  const int n = group * lanes;
  const long long blk = blockIdx.x;
  const float* xb = x + blk * n;
  const float* xs;
  int* rot;
  if constexpr (kResident) {
    xs = smem;
    rot = reinterpret_cast<int*>(smem + n);
  } else {
    xs = xb;
    rot = reinterpret_cast<int*>(smem);
  }

  block_rotations(rot, (uint32_t)ids[blk], group, lanes, salt);
  uint32_t* wb = words + blk * (n / 32);
  // n % 32 == 0 and blockDim % 32 == 0: each warp covers whole words.
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float v = xb[e];
    if constexpr (kResident) smem[e] = v;
    const unsigned bits = __ballot_sync(0xffffffffu, v != 0.0f);
    if ((threadIdx.x & 31) == 0) wb[e >> 5] = bits;
  }
  __syncthreads();

  float mx = 0.0f;
  float s = 1.0f;
  if constexpr (std::is_same<TS, int>::value) s = pow2f(mbits - exps[blk]);
  TS* sb = sketch + blk * rows * lanes;
  for (int m = threadIdx.x; m < lanes; m += blockDim.x) {
    for (int r = 0; r < rows; ++r) {
      float acc = 0.0f;
      for (int q = row_ptr[r]; q < row_ptr[r + 1]; ++q) {
        const int t = ent[q];
        int src = m - rot[t];
        if (src < 0) src += lanes;
        acc += ent_sign[q] * xs[(t / 3) * lanes + src];
      }
      store_cell(sb + r * lanes + m, acc, s);
      mx = fmaxf(mx, fabsf(acc));
    }
  }
  mx = block_max(mx, warp_max);
  if (threadIdx.x == 0) maxabs[blk] = mx;
}

// Shared-memory layout of the consumer: y, val, d (when kResident),
// current bits, bits peeled this round, rotations. Otherwise y and d are
// this block's planes of y_dev and d_dev (y then holds the dequantized
// floats on the int leg), and val is the output. TS as in the producer.
template <bool kResident, typename TS>
__global__ void __launch_bounds__(kThreads)
wire_peel_kernel(const TS* __restrict__ sketch,
                 const uint32_t* __restrict__ words,
                 const int* __restrict__ ids, const int* __restrict__ row_ptr,
                 const int* __restrict__ ent,
                 const float* __restrict__ ent_sign,
                 const int* __restrict__ hrow, const float* __restrict__ sign,
                 const int* __restrict__ exps, int mbits,
                 float* __restrict__ values, int8_t* __restrict__ residual,
                 float* y_dev, int* d_dev, int group, int lanes, int rows,
                 int rounds, uint32_t salt) {
  extern __shared__ float smem[];
  const int n = group * lanes, nw = n / 32, ns = rows * lanes;
  const long long blk = blockIdx.x;
  const uint32_t* wg = words + blk * nw;
  float* vout = values + blk * n;
  int8_t* rout = residual + blk * n;
  float *y, *val;
  int* d;
  uint32_t* bw;
  if constexpr (kResident) {
    y = smem;
    val = y + ns;
    d = reinterpret_cast<int*>(val + n);
    bw = reinterpret_cast<uint32_t*>(d + ns);
  } else {
    // Barriers order device-memory accesses within a block as they do
    // shared ones, so the rounds below hold as written.
    y = y_dev + blk * ns;
    d = d_dev + blk * ns;
    val = vout;
    bw = reinterpret_cast<uint32_t*>(smem);
  }
  uint32_t* pk = bw + nw;
  int* rot = reinterpret_cast<int*>(pk + nw);

  block_rotations(rot, (uint32_t)ids[blk], group, lanes, salt);
  float s = 1.0f;
  if constexpr (std::is_same<TS, int>::value) s = pow2f(exps[blk] - mbits);
  for (int e = threadIdx.x; e < ns; e += blockDim.x)
    y[e] = load_cell(sketch + blk * ns + e, s);
  for (int w = threadIdx.x; w < nw; w += blockDim.x) bw[w] = wg[w];
  __syncthreads();

  // Initial degrees: cell (r, m) counts the indexed coordinates hashing to it.
  for (int m = threadIdx.x; m < lanes; m += blockDim.x) {
    for (int r = 0; r < rows; ++r) {
      int cnt = 0;
      for (int q = row_ptr[r]; q < row_ptr[r + 1]; ++q) {
        const int t = ent[q];
        int src = m - rot[t];
        if (src < 0) src += lanes;
        const int e = (t / 3) * lanes + src;
        cnt += (bw[e >> 5] >> (e & 31)) & 1u;
      }
      d[r * lanes + m] = cnt;
    }
  }
  __syncthreads();

  for (int round = 0; round < rounds; ++round) {
    // Gather on the round-start y and d: a set bit with a singleton cell
    // is peeled, its value taken from the first such hash j.
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      bool peel = false;
      float v = 0.0f;
      if ((bw[e >> 5] >> (e & 31)) & 1u) {
        const int i = e / lanes, l = e - i * lanes;
        for (int j = 0; j < 3; ++j) {
          const int t = 3 * i + j;
          int col = l + rot[t];
          if (col >= lanes) col -= lanes;
          const int c = hrow[t] * lanes + col;
          if (d[c] == 1) {
            v = sign[t] * y[c];
            peel = true;
            break;
          }
        }
      }
      const unsigned pw = __ballot_sync(0xffffffffu, peel);
      if (peel) {
        if constexpr (kResident) val[e] = v;
        vout[e] = 0.0f + v;  // each element is peeled at most once
      }
      if ((threadIdx.x & 31) == 0) {
        pk[e >> 5] = pw;
        bw[e >> 5] &= ~pw;
      }
    }
    __syncthreads();
    // Scatter: subtract this round's peeled values and degrees from every
    // cell they hash to, each cell summed by its owner in (i, j) order.
    for (int m = threadIdx.x; m < lanes; m += blockDim.x) {
      for (int r = 0; r < rows; ++r) {
        float dy = 0.0f;
        int dd = 0;
        for (int q = row_ptr[r]; q < row_ptr[r + 1]; ++q) {
          const int t = ent[q];
          int src = m - rot[t];
          if (src < 0) src += lanes;
          const int e = (t / 3) * lanes + src;
          if ((pk[e >> 5] >> (e & 31)) & 1u) {
            dy += ent_sign[q] * val[e];
            ++dd;
          }
        }
        y[r * lanes + m] -= dy;
        d[r * lanes + m] -= dd;
      }
    }
    __syncthreads();
  }

  // Bits still set take the median-of-3 estimate, sum - max - min.
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const uint32_t bit = 1u << (e & 31);
    int8_t res = 0;
    if (bw[e >> 5] & bit) {
      const int i = e / lanes, l = e - i * lanes;
      float v[3];
      for (int j = 0; j < 3; ++j) {
        const int t = 3 * i + j;
        int col = l + rot[t];
        if (col >= lanes) col -= lanes;
        v[j] = sign[t] * y[hrow[t] * lanes + col];
      }
      const float med = v[0] + v[1] + v[2] - fmaxf(fmaxf(v[0], v[1]), v[2]) -
                        fminf(fminf(v[0], v[1]), v[2]);
      vout[e] = 0.0f + med;
      res = 1;
    } else if (!(wg[e >> 5] & bit)) {
      vout[e] = 0.0f;
    }
    rout[e] = res;
  }
}

int set_smem(const void* fn, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) cudaGetLastError();  // clear it; report it below
  return (int)err;
}

template <bool kResident, typename TS>
int launch_encode(const float* x, const int* ids, const int* row_ptr,
                  const int* ent, const float* ent_sign, TS* sketch,
                  uint32_t* words, float* maxabs, const int* exps, int mbits,
                  int nb, int group, int lanes, int rows, uint32_t salt,
                  size_t smem, cudaStream_t stream) {
  int err = set_smem((const void*)wire_encode_kernel<kResident, TS>, smem);
  if (err) return err;
  if (nb > 0)
    wire_encode_kernel<kResident, TS><<<nb, kThreads, smem, stream>>>(
        x, ids, row_ptr, ent, ent_sign, sketch, words, maxabs, exps, mbits,
        group, lanes, rows, salt);
  return (int)cudaGetLastError();
}

template <bool kResident, typename TS>
int launch_peel(const TS* sketch, const uint32_t* words, const int* ids,
                const int* row_ptr, const int* ent, const float* ent_sign,
                const int* hrow, const float* sign, const int* exps,
                int mbits, float* values, int8_t* residual, float* y_dev,
                int* d_dev, int nb, int group, int lanes, int rows,
                int rounds, uint32_t salt, size_t smem, cudaStream_t stream) {
  int err = set_smem((const void*)wire_peel_kernel<kResident, TS>, smem);
  if (err) return err;
  if (nb > 0)
    wire_peel_kernel<kResident, TS><<<nb, kThreads, smem, stream>>>(
        sketch, words, ids, row_ptr, ent, ent_sign, hrow, sign, exps, mbits,
        values, residual, y_dev, d_dev, group, lanes, rows, rounds, salt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The most dynamic shared memory a block may opt in to on `device`, or a
// negative cudaError_t.
int sketch_wire_max_smem(int device) {
  int v = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? v : -(int)err;
}

// Dynamic shared memory of each kernel; `resident` keeps the x block (the
// producer) or y, d and the peeled values (the consumer) there too.
size_t sketch_wire_encode_smem(int group, int lanes, int resident) {
  return sizeof(float) * (resident ? (size_t)group * lanes : 0) +
         sizeof(int) * 3 * (size_t)group;
}

size_t sketch_wire_peel_smem(int group, int lanes, int rows, int resident) {
  const size_t n = (size_t)group * lanes, ns = (size_t)rows * lanes;
  return (resident ? sizeof(float) * (ns + n) + sizeof(int) * ns : 0) +
         sizeof(uint32_t) * 2 * (n / 32) + sizeof(int) * 3 * (size_t)group;
}

// exps == NULL: the f32 wire, `sketch` is float. Otherwise the quantize
// leg: (nb,) int32 exponents, mantissa bits `mbits`, `sketch` is int32.
int sketch_wire_encode(const float* x, const int* ids, const int* row_ptr,
                       const int* ent, const float* ent_sign, void* sketch,
                       int* words, float* maxabs, const int* exps, int nb,
                       int group, int lanes, int rows, int mbits,
                       int resident, unsigned salt, void* stream) {
  const size_t smem = sketch_wire_encode_smem(group, lanes, resident);
  uint32_t* w = reinterpret_cast<uint32_t*>(words);
  cudaStream_t st = (cudaStream_t)stream;
  if (exps == nullptr) {
    float* sk = static_cast<float*>(sketch);
    return resident
               ? launch_encode<true>(x, ids, row_ptr, ent, ent_sign, sk, w,
                                     maxabs, exps, mbits, nb, group, lanes,
                                     rows, salt, smem, st)
               : launch_encode<false>(x, ids, row_ptr, ent, ent_sign, sk, w,
                                      maxabs, exps, mbits, nb, group, lanes,
                                      rows, salt, smem, st);
  }
  int* sk = static_cast<int*>(sketch);
  return resident
             ? launch_encode<true>(x, ids, row_ptr, ent, ent_sign, sk, w,
                                   maxabs, exps, mbits, nb, group, lanes,
                                   rows, salt, smem, st)
             : launch_encode<false>(x, ids, row_ptr, ent, ent_sign, sk, w,
                                    maxabs, exps, mbits, nb, group, lanes,
                                    rows, salt, smem, st);
}

// y_dev (nb, rows, lanes) f32 and d_dev (nb, rows, lanes) int32 are
// scratch for resident == 0 and unused otherwise. exps == NULL: `sketch`
// is the f32 aggregate; otherwise the int32 fxp32 aggregate, dequantized
// with (nb,) int32 exponents and mantissa bits `mbits`.
int sketch_wire_peel(const void* sketch, const int* words, const int* ids,
                     const int* row_ptr, const int* ent,
                     const float* ent_sign, const int* hrow,
                     const float* sign, const int* exps, float* values,
                     signed char* residual, float* y_dev, int* d_dev, int nb,
                     int group, int lanes, int rows, int rounds, int mbits,
                     int resident, unsigned salt, void* stream) {
  const size_t smem = sketch_wire_peel_smem(group, lanes, rows, resident);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(words);
  int8_t* res = reinterpret_cast<int8_t*>(residual);
  cudaStream_t st = (cudaStream_t)stream;
  if (exps == nullptr) {
    const float* sk = static_cast<const float*>(sketch);
    return resident
               ? launch_peel<true>(sk, w, ids, row_ptr, ent, ent_sign, hrow,
                                   sign, exps, mbits, values, res, y_dev,
                                   d_dev, nb, group, lanes, rows, rounds,
                                   salt, smem, st)
               : launch_peel<false>(sk, w, ids, row_ptr, ent, ent_sign, hrow,
                                    sign, exps, mbits, values, res, y_dev,
                                    d_dev, nb, group, lanes, rows, rounds,
                                    salt, smem, st);
  }
  const int* sk = static_cast<const int*>(sketch);
  return resident
             ? launch_peel<true>(sk, w, ids, row_ptr, ent, ent_sign, hrow,
                                 sign, exps, mbits, values, res, y_dev, d_dev,
                                 nb, group, lanes, rows, rounds, salt, smem,
                                 st)
             : launch_peel<false>(sk, w, ids, row_ptr, ent, ent_sign, hrow,
                                  sign, exps, mbits, values, res, y_dev,
                                  d_dev, nb, group, lanes, rows, rounds, salt,
                                  smem, st);
}

}  // extern "C"
