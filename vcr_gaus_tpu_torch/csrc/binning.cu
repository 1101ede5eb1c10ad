// Tile binning for NVIDIA Hopper (sm_90a): the (Gaussian, tile) entries of
// one view sorted by tile and depth, and each tile's range, over 32-bit keys
// and int32 Gaussian indices, with one host wait a view.
//
// Replaces no TPU kernel. The JAX package bins with XLA
// (vcr_gaus_tpu/ops/binning.py `bin_gaussians`: an analytic expansion and
// ONE stable sort of a packed uint32 key). The port ran it as an eager int64
// chain of about 20 launches a view (ops/binning.py `bin_gaussians_torch`,
// now the plain version for CPU tensors and the card tests): int64 gathers
// by `repeat_interleave`'s gid, a stable sort of int64 keys with int64
// indices (8 passes of 16 B an entry), `bincount`, and three host waits,
// the last two after the sort was queued, so the host stood still for all of
// binning's device time. Here (ops/binning.py `bin_gaussians` on a CUDA
// tensor):
//
//   vcr_binning_count: per slot g its tile rectangle [x0, x1) x [y0, y1)
//     and entry count (x1 - x0)(y1 - y0) where alive, else 0; the totals E
//     (64-bit) and the binned Gaussians (count > 0), one atomic pair a
//     block; then the exclusive scan of the int32 counts
//     (cub::DeviceScan::ExclusiveSum): each slot's first entry.
//   [the wrapper reads the two totals, the one wait; it raises where E
//     does not fit in int32 and allocates the E-sized buffers]
//   vcr_binning_sort: each alive slot's entries at its offset, row-major in
//     its rectangle, as in the plain chain: key (tile << db) | (the float32
//     depth's bits >> (32 - db)), value g (a warp walks the one run of
//     entries its 32 slots own, a lane an entry, so the stores coalesce and
//     neither a large rectangle nor many small ones hold a lane); one LSD
//     radix sort of the (uint32, int32) pairs over bits [0, 32)
//     (cub::DeviceRadixSort::SortPairs: 4 passes of 8 bits, 8 B an entry);
//     then each tile's start, the first entry whose key is at least
//     tile << db (a binary search a tile), and its count, the next tile's
//     start less its own.
//
// The order: entries enter the sort in the plain chain's expansion order
// (slot, then row-major in the rectangle) and a radix sort is stable, so
// each tile's gid sequence equals the plain chain's, and the JAX
// package's, exactly. A tile's start is the number of entries of the tiles
// before it, cumsum(counts) - counts over every tile, empty ones included,
// as the plain chain forms it. The tile ranges take one launch over the
// tiles in place of a pass over the entries that marks where the tile
// changes: no scratch, no memset and no scan, and the same numbers.
//
// The arithmetic is the plain chain's on the card: the rectangle in
// float32, operation for operation in its order ((m - r) / 16 and
// (((m + r) + 16) - 1) / 16; a division by 16 is exact either way, as a
// division or as PyTorch's multiply by the reciprocal), each rounded alone
// (explicit _rn intrinsics; the library is built with --fmad=false), the
// conversion to int32 truncating toward zero and saturating as PyTorch's
// float -> int32 conversion on the card does (cvt.rzi), then clamped to
// the grid. The key fits in 32 bits by design: db = 32 - bitlen(tiles).
//
// What bounds it on the card: the bytes. The function needs 24 B a slot
// (mean2d 8, radius 4, depth 4, extents 8 read) and 4 B an entry (the
// sorted gid) and 8 B a tile written. A radix sort needs its passes, so the
// design moves about 80 B an entry (the expansion writes 8; four passes
// read and write 8 each, 64; the first pass's histogram reads the keys
// again, 4; the tile search a few) and about 60 B a slot (the count reads
// up to 24 and writes 4; the scan reads and writes 4 each, more in its
// look-back; the expansion reads radius and offset and, where alive, the
// rectangle's inputs and the depth again): at 3.35 TB/s 0.68 ms for
// m360's 22.4M entries from 8.4M slots. The int64 chain moved about three
// times as much and waited on the host between its parts.

#include <cstdint>

#include <cuda_runtime.h>

#include <cub/block/block_reduce.cuh>
#include <cub/device/device_radix_sort.cuh>
#include <cub/device/device_scan.cuh>

namespace {

constexpr int TILE = 16;
constexpr int THREADS = 256;
constexpr int SLOTS = 4;                 // slots a thread of the count takes
constexpr unsigned FULL = 0xffffffffu;

// One view's per-slot inputs: mean2d (n, 2) and extents (n, 2), or null
// for none, float32; the radius (n,) int32.
struct Slots {
    const float* mean2d;
    const int* radius;
    const float* ext;
    int n;
    int n_tx;
    int n_ty;
};

struct Rect {
    int x0;
    int y0;
    int w;
    int count;
};

__device__ __forceinline__ int clamp_grid(int v, int hi)
{
    return min(max(v, 0), hi);
}

// The plain chain's first tile of an axis: int((m - r) / 16), clamped.
__device__ __forceinline__ int first_tile(float m, float r, int n)
{
    return clamp_grid(__float2int_rz(__fdiv_rn(__fsub_rn(m, r), 16.0f)), n);
}

// The plain chain's end tile of an axis: int((((m + r) + 16) - 1) / 16),
// clamped.
__device__ __forceinline__ int end_tile(float m, float r, int n)
{
    const float hi = __fsub_rn(__fadd_rn(__fadd_rn(m, r), (float)TILE), 1.0f);
    return clamp_grid(__float2int_rz(__fdiv_rn(hi, 16.0f)), n);
}

// Slot g's rectangle and entry count; all zero where it is not alive:
// radius <= 0, or, with extents, an extent <= 0 (NaN included, as the
// plain chain's comparisons).
__device__ __forceinline__ Rect rect_of(const Slots& s, int g)
{
    Rect r = {0, 0, 0, 0};
    const int radius = s.radius[g];
    bool alive = radius > 0;
    float rx = __int2float_rn(radius), ry = rx;
    if (alive && s.ext) {
        rx = s.ext[2 * (long long)g];
        ry = s.ext[2 * (long long)g + 1];
        alive = rx > 0.0f && ry > 0.0f;
    }
    if (!alive)
        return r;
    const float mx = s.mean2d[2 * (long long)g];
    const float my = s.mean2d[2 * (long long)g + 1];
    r.x0 = first_tile(mx, rx, s.n_tx);
    r.y0 = first_tile(my, ry, s.n_ty);
    r.w = max(end_tile(mx, rx, s.n_tx) - r.x0, 0);
    r.count = r.w * max(end_tile(my, ry, s.n_ty) - r.y0, 0);
    return r;
}

// counts[g] = slot g's entries; totals[0] += the block's entries,
// totals[1] += its slots with an entry (both zeroed before the launch).
__global__ void __launch_bounds__(THREADS)
    count_kernel(Slots s, int* __restrict__ counts,
                 unsigned long long* __restrict__ totals)
{
    using Reduce = cub::BlockReduce<unsigned long long, THREADS>;
    __shared__ typename Reduce::TempStorage tmp;
    unsigned long long entries = 0, binned = 0;
    const long long base = (long long)blockIdx.x * (THREADS * SLOTS)
                           + threadIdx.x;
    for (int k = 0; k < SLOTS; ++k) {
        const long long g = base + k * THREADS;
        if (g < s.n) {
            const int c = rect_of(s, (int)g).count;
            counts[g] = c;
            entries += (unsigned long long)c;
            binned += c > 0;
        }
    }
    entries = Reduce(tmp).Sum(entries);
    __syncthreads();
    binned = Reduce(tmp).Sum(binned);
    if (threadIdx.x == 0) {
        if (entries)
            atomicAdd(&totals[0], entries);
        if (binned)
            atomicAdd(&totals[1], binned);
    }
}

// Each alive slot's entries at offsets[g], row-major in its rectangle.
// The 32 slots of a warp own one run of entries, [offsets of its first
// slot, the end of its last), since the offsets are the scan of the counts
// in slot order; the warp walks that run 32 entries at a time, a lane an
// entry, so every store is coalesced and a warp's work is its entries
// whatever their split among its slots. An entry's slot is the last lane
// whose offset is at most the entry's index (a slot without entries shares
// its offset with the next slot that has some, so it is never the last);
// its rectangle and depth bits come from that lane by shuffle. Every lane
// reaches every shuffle: a lane past n holds offset e and count 0.
__global__ void __launch_bounds__(THREADS)
    expand_kernel(Slots s, const float* __restrict__ depth, int db,
                  const int* __restrict__ offsets, int e,
                  unsigned* __restrict__ keys, int* __restrict__ vals)
{
    const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
    const int lane = threadIdx.x & 31;
    Rect r = {0, 0, 0, 0};
    int off = e;
    unsigned dq = 0;
    if (g < s.n) {
        off = offsets[g];
        r = rect_of(s, (int)g);
        if (r.count)
            dq = __float_as_uint(depth[g]) >> (32 - db);
    }
    const int first = (int)(g - lane);
    const int begin = __shfl_sync(FULL, off, 0);
    const int end = __shfl_sync(FULL, off + r.count, 31);
    for (int base = begin; base < end; base += 32) {
        const int q = base + lane;
        int j = 0;
        for (int step = 16; step > 0; step >>= 1)
            if (__shfl_sync(FULL, off, j + step) <= q)
                j += step;
        const int i = q - __shfl_sync(FULL, off, j);
        const int x0 = __shfl_sync(FULL, r.x0, j);
        const int y0 = __shfl_sync(FULL, r.y0, j);
        const int w = __shfl_sync(FULL, r.w, j);
        const unsigned d = __shfl_sync(FULL, dq, j);
        if (q < end) {
            const int sy = i / w;
            const unsigned tile =
                (unsigned)((y0 + sy) * s.n_tx + x0 + (i - sy * w));
            keys[q] = (tile << db) | d;
            vals[q] = first + j;
        }
    }
}

// The first of the e sorted keys that is at least `key`, or e.
__device__ __forceinline__ int lower_bound(const unsigned* __restrict__ keys,
                                           int e, unsigned long long key)
{
    int lo = 0, hi = e;
    while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        if (keys[mid] < key)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

// Each tile's first entry and entry count over the sorted keys.
__global__ void __launch_bounds__(THREADS)
    ranges_kernel(const unsigned* __restrict__ keys, int e, int db,
                  int n_tiles, int* __restrict__ starts,
                  int* __restrict__ counts)
{
    const int t = blockIdx.x * THREADS + threadIdx.x;
    if (t >= n_tiles)
        return;
    const int start = lower_bound(keys, e, (unsigned long long)t << db);
    starts[t] = start;
    counts[t] = lower_bound(keys, e, (unsigned long long)(t + 1) << db)
                - start;
}

// The one scan and the one sort this library instantiates, each called
// alike for its scratch size and its run.
cudaError_t scan(void* tmp, size_t& bytes, const int* in, int* out, int n,
                 cudaStream_t stream)
{
    return cub::DeviceScan::ExclusiveSum(tmp, bytes, in, out, n, stream);
}

cudaError_t sort(void* tmp, size_t& bytes, cub::DoubleBuffer<unsigned>& k,
                 cub::DoubleBuffer<int>& v, int e, cudaStream_t stream)
{
    return cub::DeviceRadixSort::SortPairs(tmp, bytes, k, v, e, 0, 32,
                                           stream);
}

int blocks_of(long long items, long long per_block)
{
    return (int)((items + per_block - 1) / per_block);
}

}  // namespace

// The scratch bytes of the count's scan over n slots, or -(the error).
extern "C" long long vcr_binning_scan_bytes(int n)
{
    size_t bytes = 0;
    const cudaError_t err = scan(nullptr, bytes, nullptr, nullptr, n, 0);
    return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// The scratch bytes of the sort of e entries, or -(the error).
extern "C" long long vcr_binning_sort_bytes(int e)
{
    size_t bytes = 0;
    cub::DoubleBuffer<unsigned> k(nullptr, nullptr);
    cub::DoubleBuffer<int> v(nullptr, nullptr);
    const cudaError_t err = sort(nullptr, bytes, k, v, e, 0);
    return err == cudaSuccess ? (long long)bytes : -(long long)err;
}

// The count: counts[g] and offsets[g] (n int32 each) <- slot g's entries
// and its first entry; totals (two int64) <- [E, binned]. scan_tmp holds
// vcr_binning_scan_bytes(n) bytes. Returns the first error (0 =
// cudaSuccess); runs on `stream`, not awaited.
extern "C" int vcr_binning_count(const float* mean2d, const int* radius,
                                 const float* ext, int n, int n_tx, int n_ty,
                                 int* counts, int* offsets, void* scan_tmp,
                                 long long scan_bytes, long long* totals,
                                 void* stream)
{
    const cudaStream_t s = (cudaStream_t)stream;
    cudaError_t err = cudaMemsetAsync(totals, 0, 2 * sizeof(long long), s);
    if (err != cudaSuccess || n == 0)
        return (int)err;
    count_kernel<<<blocks_of(n, THREADS * SLOTS), THREADS, 0, s>>>(
        Slots{mean2d, radius, ext, n, n_tx, n_ty}, counts,
        (unsigned long long*)totals);
    err = cudaGetLastError();
    if (err != cudaSuccess)
        return (int)err;
    size_t bytes = (size_t)scan_bytes;
    return (int)scan(scan_tmp, bytes, counts, offsets, n, s);
}

// The sort: with the count's offsets and e entries (< 2^31), the e
// (key, gid) pairs sorted into keys0/vals0 or keys1/vals1 (e each; which
// one is written to *selector, 0 or 1), and each of the n_tiles tiles' first
// entry and count. sort_tmp holds vcr_binning_sort_bytes(e) bytes. Returns
// the first error; runs on `stream`, not awaited.
extern "C" int vcr_binning_sort(const float* mean2d, const int* radius,
                                const float* ext, int n, int n_tx, int n_ty,
                                const float* depth, int db,
                                const int* offsets, int e, unsigned* keys0,
                                unsigned* keys1, int* vals0, int* vals1,
                                void* sort_tmp, long long sort_bytes,
                                int* tile_starts, int* tile_counts,
                                int n_tiles, int* selector, void* stream)
{
    const cudaStream_t s = (cudaStream_t)stream;
    *selector = 0;
    if (e > 0) {
        expand_kernel<<<blocks_of(n, THREADS), THREADS, 0, s>>>(
            Slots{mean2d, radius, ext, n, n_tx, n_ty}, depth, db, offsets, e,
            keys0, vals0);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess)
            return (int)err;
        cub::DoubleBuffer<unsigned> k(keys0, keys1);
        cub::DoubleBuffer<int> v(vals0, vals1);
        size_t bytes = (size_t)sort_bytes;
        err = sort(sort_tmp, bytes, k, v, e, s);
        if (err != cudaSuccess)
            return (int)err;
        *selector = k.selector;     // the values' buffer turns with the keys
    }
    ranges_kernel<<<blocks_of(n_tiles, THREADS), THREADS, 0, s>>>(
        *selector ? keys1 : keys0, e, db, n_tiles, tile_starts, tile_counts);
    return (int)cudaGetLastError();
}
