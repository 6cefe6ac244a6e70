// The row gather: out[i, :] = tab[idx[i], :].
//
// Replaces the Pallas kernel profiling/prof_gather.py `gather_kernel`
// (launched by `pallas_gather`): 524,288 int32 indices into a (16384, 16)
// f32 table, 8K rows a grid step, with the table resident in VMEM.
//
// What bounds it on the H100.  It moves the indices (4 B a row) and the
// output (64 B a row) once, and the 1 MB table, which stays in the 50 MB
// L2 after its first reads: ~36 MB, ~11 us at 3.35 TB/s.  It does no
// arithmetic, so it is bound by bytes.
//
// What the design does about it.  One thread per 16-byte quarter of a
// row (the row's width in float4s a row, 4 for 16 f32): the threads of
// a warp cover 8 consecutive output rows, so every store is a coalesced
// 512-byte run, and each table read is one float4 of a 64-byte row in
// L2.  The index is read once per thread through the read-only cache
// (the quarter-warp of a row reads the same word).  No shared memory,
// no reduction: the TPU kernel's VMEM residency is the L2's here.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const float4* __restrict__ tab, const int* __restrict__ idx,
                   long long n_rows, int row4, float4* __restrict__ out)
{
    const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (t >= n_rows * row4) return;
    const long long i = t / row4;
    const int part = (int)(t - i * row4);
    const int r = __ldg(idx + i);
    out[t] = __ldg(tab + (long long)r * row4 + part);
}

}  // namespace

// tab: (rows, 4 * row4) f32, 16-byte aligned; idx: (n_rows,) int32 in
// [0, rows); out: (n_rows, 4 * row4) f32.
extern "C" int gather_rows_launch(const void* tab, const int* idx, long long n_rows,
                                  int row4, void* out, void* stream)
{
    const long long n = n_rows * row4;
    if (n == 0) return 0;
    const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
    gather_rows_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float4*)tab, idx, n_rows, row4, (float4*)out);
    return (int)cudaGetLastError();
}
