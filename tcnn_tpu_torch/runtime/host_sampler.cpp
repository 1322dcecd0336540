// Host-side native helper of tcnn_tpu_torch: the PCG32 generator and the
// threaded image batch sampler of utils/data.py (HostImageSampler).
//
// PCG32 (M.E. O'Neill, www.pcg-random.org, Apache-2.0) is the same public
// algorithm the reference vendors (dependencies/pcg32/pcg32.h); the sampler
// seeds and draws it exactly as the JAX package's native sampler does, so
// the two give the same batches bit for bit, except that a stratified
// sample the JAX package's sampler puts on or past its tile's edge is
// moved inside the tile here (in_tile()). (The JAX package's library
// also exports bulk PCG32 draws for parameter initialisation; the port
// initialises in Python, tcnn_tpu_torch/rng.py, and has no use for them.)
// Built with g++ at first use (runtime/native.py); no device code.

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t PCG32_MULT = 0x5851f42d4c957f2dULL;

inline uint32_t pcg32_output(uint64_t oldstate) {
    uint32_t xorshifted = (uint32_t)(((oldstate >> 18u) ^ oldstate) >> 27u);
    uint32_t rot = (uint32_t)(oldstate >> 59u);
    return (xorshifted >> rot) | (xorshifted << ((~rot + 1u) & 31));
}

} // namespace

// ---------------------------------------------------------------------------
// Threaded host-side batch sampler (the reference streams training batches
// from a CUDA texture on the device, samples/mlp_learning_an_image.cu:259-307;
// for datasets that live in host RAM the analogue is an asynchronous
// producer that overlaps batch synthesis with device steps).
// Produces (xy, rgb) pairs: jittered-stratified raster order (the grid
// encoding's fast-path layout) or i.i.d. uniform, nearest-pixel targets.
// ---------------------------------------------------------------------------

#include <atomic>
#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Buffer {
    std::vector<float> xy;
    std::vector<float> rgb;
    bool ready = false;
};

struct Sampler {
    const float* image;  // (h, w, c) row-major, NOT owned
    int64_t h, w, c;
    int64_t batch;
    int strata;          // 0 = iid uniform, else tiles per dim (2-D)
    uint64_t rng_state, rng_inc;
    std::vector<Buffer> ring;
    size_t head = 0, tail = 0;  // consume at head, produce at tail
    std::mutex mu;
    std::condition_variable cv_produce, cv_consume;
    std::atomic<bool> stop{false};
    std::thread worker;
};

inline uint32_t next_u32(Sampler& s) {
    uint64_t old = s.rng_state;
    s.rng_state = old * PCG32_MULT + s.rng_inc;
    return pcg32_output(old);
}

inline float next_f32(Sampler& s) {
    uint32_t bits = (next_u32(s) >> 9) | 0x3f800000u;
    float f;
    std::memcpy(&f, &bits, sizeof(f));
    return f - 1.0f;
}

// The stratified coordinate of raster tile `tile` for the jitter u in [0, 1):
// (tile + u) / strata in fp32, as the JAX package's sampler computes it, and
// that value itself wherever it lies in [tile, tile + 1) / strata. Where the
// fp32 sum tile + u rounds up to tile + 1 (u within an ulp of the tile
// index below 1: at 512 tiles a side, u within 2^-16 of 1), or the quotient
// rounds across an edge of the tile, it is moved by single fp32 steps to the
// nearest value inside the tile. (double)v * strata is exact (a 24-bit
// mantissa times an int below 2^29), so the test is too.
inline float in_tile(int64_t tile, float u, int strata) {
    float v = (tile + u) / strata;
    while ((double)v * strata >= (double)(tile + 1)) v = std::nextafter(v, 0.0f);
    while ((double)v * strata < (double)tile) v = std::nextafter(v, 1.0f);
    return v;
}

void fill_buffer(Sampler& s, Buffer& b) {
    const int64_t B = s.batch;
    b.xy.resize(B * 2);
    b.rgb.resize(B * s.c);
    for (int64_t j = 0; j < B; ++j) {
        float x, y;
        if (s.strata > 0) {
            const int64_t col = j % s.strata, row = j / s.strata;
            x = in_tile(col, next_f32(s), s.strata);
            y = in_tile(row, next_f32(s), s.strata);
        } else {
            x = next_f32(s);
            y = next_f32(s);
        }
        b.xy[j * 2 + 0] = x;
        b.xy[j * 2 + 1] = y;
        int64_t px = (int64_t)(x * s.w);
        int64_t py = (int64_t)(y * s.h);
        if (px >= s.w) px = s.w - 1;
        if (py >= s.h) py = s.h - 1;
        const float* src = s.image + (py * s.w + px) * s.c;
        std::memcpy(&b.rgb[j * s.c], src, s.c * sizeof(float));
    }
}

void worker_loop(Sampler* s) {
    for (;;) {
        std::unique_lock<std::mutex> lk(s->mu);
        s->cv_produce.wait(lk, [&] {
            return s->stop.load() || !s->ring[s->tail].ready;
        });
        if (s->stop.load()) return;
        Buffer& b = s->ring[s->tail];
        lk.unlock();
        fill_buffer(*s, b);
        lk.lock();
        b.ready = true;
        s->tail = (s->tail + 1) % s->ring.size();
        s->cv_consume.notify_one();
    }
}

}  // namespace

extern "C" {

void* sampler_create(const float* image, int64_t h, int64_t w, int64_t c,
                     int64_t batch, int strata, uint64_t seed,
                     int n_buffers) {
    auto* s = new Sampler();
    s->image = image;
    s->h = h; s->w = w; s->c = c;
    s->batch = batch;
    s->strata = strata;
    // pcg32 seeding (pcg32.h semantics: seed(initstate, initseq=1))
    s->rng_state = 0u; s->rng_inc = (1ull << 1) | 1u;
    s->rng_state = s->rng_state * PCG32_MULT + s->rng_inc;
    s->rng_state += seed;
    s->rng_state = s->rng_state * PCG32_MULT + s->rng_inc;
    s->ring.resize(n_buffers > 1 ? n_buffers : 2);
    s->worker = std::thread(worker_loop, s);
    return s;
}

// Blocks until the next batch is ready, copies it out, releases the slot.
void sampler_next(void* handle, float* xy_out, float* rgb_out) {
    auto* s = static_cast<Sampler*>(handle);
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv_consume.wait(lk, [&] { return s->ring[s->head].ready; });
    Buffer& b = s->ring[s->head];
    lk.unlock();
    std::memcpy(xy_out, b.xy.data(), b.xy.size() * sizeof(float));
    std::memcpy(rgb_out, b.rgb.data(), b.rgb.size() * sizeof(float));
    lk.lock();
    b.ready = false;
    s->head = (s->head + 1) % s->ring.size();
    s->cv_produce.notify_one();
}

void sampler_destroy(void* handle) {
    auto* s = static_cast<Sampler*>(handle);
    {
        std::lock_guard<std::mutex> lk(s->mu);
        s->stop.store(true);
    }
    s->cv_produce.notify_all();
    s->worker.join();
    delete s;
}

}  // extern "C"
