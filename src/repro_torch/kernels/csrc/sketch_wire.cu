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
// The owner-sum encode and the peel rounds live in sketch_tile.cuh, shared
// with the standalone encode and peel of sketch_codec.cu. The TPU kernels'
// one-hot plan-matrix contraction, VMEM budgets and multi-block grid cells
// are not carried over. Several blocks per CUDA block, cp.async/TMA
// staging and a warp-specialised peel are later work.
//
// Interface: plain C, loaded with ctypes. Each function returns the
// cudaError_t of the launch (0 on success). Words are uint32 bits (the
// PyTorch side stores them in int32 tensors).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sketch_tile.cuh"

using namespace sketch_tile;

namespace {

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

  float s = 1.0f;
  if constexpr (std::is_same<TS, int>::value) s = pow2f(mbits - exps[blk]);
  float mx = encode_cells(xs, rot, row_ptr, ent, ent_sign,
                          sketch + blk * rows * lanes, s, lanes, rows);
  mx = block_max(mx, warp_max);
  if (threadIdx.x == 0) maxabs[blk] = mx;
}

// The consumer: its state as sketch_tile::peel_planes lays it out (y then
// holds the dequantized floats on the int leg). TS as in the producer.
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
  const PeelPlanes p =
      peel_planes<kResident>(smem, y_dev, d_dev, vout, blk, n, ns, nw);

  block_rotations(p.rot, (uint32_t)ids[blk], group, lanes, salt);
  float s = 1.0f;
  if constexpr (std::is_same<TS, int>::value) s = pow2f(exps[blk] - mbits);
  for (int e = threadIdx.x; e < ns; e += blockDim.x)
    p.y[e] = load_cell(sketch + blk * ns + e, s);
  for (int w = threadIdx.x; w < nw; w += blockDim.x) p.bw[w] = wg[w];
  __syncthreads();

  peel_block<kResident>(p, row_ptr, ent, ent_sign, hrow, sign, vout,
                        residual + blk * n, WordBits{wg}, n, lanes, rows,
                        rounds);
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
int sketch_wire_max_smem(int device) { return max_smem_optin(device); }

// Dynamic shared memory of each kernel; `resident` keeps the x block (the
// producer) or y, d and the peeled values (the consumer) there too.
size_t sketch_wire_encode_smem(int group, int lanes, int resident) {
  return encode_smem(group, lanes, resident);
}

size_t sketch_wire_peel_smem(int group, int lanes, int rows, int resident) {
  return peel_smem(group, lanes, rows, resident);
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
