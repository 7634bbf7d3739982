// The PyTorch port's native host runtime (a copy of
// bigdl_tpu/native/bigdl_native.cpp, built by bigdl_tpu_torch/dataset/
// native.py): a multi-threaded prefetching input pipeline, libjpeg decode
// and the binary dataset readers.
//
// The reference's multi-threaded ImageNet input path
// (image/MTLabeledBGRImgToBatch.scala:48-133) has coreNumber cloned
// transformer pipelines race on an atomic batch-position counter to
// decode/augment into one shared batch buffer. Here worker threads claim
// batch *tickets* from an atomic counter, run crop/flip/normalize over raw
// uint8 samples, and hand finished float batches, strictly in ticket
// order, to the training loop through a bounded queue while the card runs
// the previous step.
//
// Beside the JAX package's C ABI, bt_pipeline_create_at starts an endless
// pipeline at a given ticket, so a resumed run continues the batch stream
// of the run it resumes.
//
// Exposed as a plain C ABI for ctypes (no pybind11).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#ifdef BT_WITH_JPEG
#include <csetjmp>
#include <jpeglib.h>
#endif

namespace {

struct Batch {
    long index;
    std::vector<float> images;
    std::vector<int32_t> labels;
};

struct Pipeline {
    // dataset (borrowed pointers — caller keeps them alive)
    const uint8_t* images = nullptr;
    const int32_t* labels = nullptr;
    int64_t n = 0;
    int h = 0, w = 0, c = 0;

    // batch/augment config
    int batch = 0;
    int crop_h = 0, crop_w = 0;
    bool random_crop = false;
    bool hflip = false;
    std::vector<float> mean, stdev;  // per-channel
    std::vector<float> mean_row, std_row;  // repeated along a crop row
    bool shuffle = true;
    bool loop = false;
    uint64_t seed = 0;

    // runtime
    long batches_per_epoch = 0;
    std::atomic<long> ticket{0};
    std::vector<std::thread> workers;
    size_t queue_cap = 4;
    // finished batches keyed by ticket: delivery is strictly in ticket
    // order (epoch boundaries and eval sample order must be exact even
    // though workers complete out of order)
    std::map<long, Batch> ready;
    std::mutex mu;
    std::condition_variable cv_space, cv_ready;
    bool stopping = false;
    long delivered = 0;  // == next ticket to hand to the consumer

    // batch buffers the consumer has copied out, handed to the next
    // worker: a worker then writes memory that is already mapped instead
    // of a fresh (zero-filled, page-faulting) allocation per batch
    std::mutex spare_mu;
    std::vector<Batch> spare;

    Batch take_buffer() {
        std::lock_guard<std::mutex> lk(spare_mu);
        if (spare.empty()) return Batch();
        Batch b = std::move(spare.back());
        spare.pop_back();
        return b;
    }

    void give_buffer(Batch&& b) {
        std::lock_guard<std::mutex> lk(spare_mu);
        if (spare.size() < queue_cap + workers.size())
            spare.push_back(std::move(b));
    }

    // per-epoch permutations (epoch -> shuffled index array); workers near
    // an epoch boundary may need two epochs' perms concurrently
    std::mutex perm_mu;
    std::map<long, std::shared_ptr<std::vector<uint32_t>>> perms;

    std::shared_ptr<std::vector<uint32_t>> perm_for(long epoch) {
        std::lock_guard<std::mutex> lk(perm_mu);
        auto it = perms.find(epoch);
        if (it != perms.end()) return it->second;
        auto p = std::make_shared<std::vector<uint32_t>>(n);
        for (int64_t i = 0; i < n; ++i) (*p)[i] = (uint32_t)i;
        if (shuffle) {
            std::mt19937_64 rng(seed * 0x9E3779B97F4A7C15ULL + (uint64_t)epoch);
            for (int64_t i = n - 1; i > 0; --i) {
                std::uniform_int_distribution<int64_t> d(0, i);
                std::swap((*p)[i], (*p)[d(rng)]);
            }
        }
        perms[epoch] = p;
        // prune stale epochs (keep a small sliding window)
        while (perms.size() > 3) perms.erase(perms.begin());
        return p;
    }
};

// Core pixel loop shared by the in-memory pipeline and the streaming
// per-sample augment: crop at (off_h, off_w) from a (src_h, src_w, c)
// uint8 HWC source, optional horizontal flip, per-channel (x - mean)/std
// normalize into float HWC dst of (ch, cw, c). mean_row/std_row hold the
// per-channel values repeated along a row (cw * c floats), so a row is
// one elementwise loop the compiler vectorizes; a flipped row is then
// reversed pixel by pixel. Each value is the same (x - mean) / std in
// float32 as a per-pixel loop's, so the bits do not change.
void augment_core(const uint8_t* src, int src_w, int c, float* dst, int ch,
                  int cw, int off_h, int off_w, bool flip,
                  const float* __restrict mean_row,
                  const float* __restrict std_row) {
    const int n = cw * c;
    for (int y = 0; y < ch; ++y) {
        const uint8_t* __restrict row =
            src + ((int64_t)(y + off_h) * src_w + off_w) * c;
        float* __restrict out = dst + (int64_t)y * n;
        for (int j = 0; j < n; ++j)
            out[j] = ((float)row[j] - mean_row[j]) / std_row[j];
        if (flip)
            for (int a = 0, b = cw - 1; a < b; ++a, --b)
                for (int k = 0; k < c; ++k)
                    std::swap(out[a * c + k], out[b * c + k]);
    }
}

// mean or std of c channels repeated along a row of cw pixels
std::vector<float> channel_row(const float* v, int c, int cw) {
    std::vector<float> row((size_t)cw * c);
    for (int j = 0; j < cw * c; ++j) row[j] = v[j % c];
    return row;
}

// Fill one sample slot: crop (random or center), optional horizontal flip,
// per-channel (x - mean) / std normalization, uint8 HWC -> float HWC.
void fill_sample(const Pipeline* p, const uint8_t* src, float* dst,
                 std::mt19937_64& rng) {
    const int ch = p->crop_h, cw = p->crop_w, c = p->c;
    int off_h = (p->h - ch) / 2, off_w = (p->w - cw) / 2;
    if (p->random_crop && (p->h > ch || p->w > cw)) {
        if (p->h > ch) {
            std::uniform_int_distribution<int> d(0, p->h - ch);
            off_h = d(rng);
        }
        if (p->w > cw) {
            std::uniform_int_distribution<int> d(0, p->w - cw);
            off_w = d(rng);
        }
    }
    bool flip = false;
    if (p->hflip) {
        std::uniform_int_distribution<int> d(0, 1);
        flip = d(rng) == 1;
    }
    augment_core(src, p->w, c, dst, ch, cw, off_h, off_w, flip,
                 p->mean_row.data(), p->std_row.data());
}

void worker_main(Pipeline* p) {
    const int64_t sample_elems = (int64_t)p->crop_h * p->crop_w * p->c;
    for (;;) {
        long t = p->ticket.fetch_add(1);
        if (!p->loop && t >= p->batches_per_epoch) break;
        long epoch = t / p->batches_per_epoch;
        long b = t % p->batches_per_epoch;
        auto perm = p->perm_for(epoch);

        Batch out = p->take_buffer();
        out.index = t;
        out.images.resize((size_t)p->batch * sample_elems);
        out.labels.resize(p->batch);
        // ticket-seeded rng: augmentation is reproducible regardless of
        // which thread runs the ticket
        std::mt19937_64 rng(p->seed ^ (0xD1B54A32D192ED03ULL * (uint64_t)(t + 1)));
        for (int i = 0; i < p->batch; ++i) {
            uint32_t idx = (*perm)[(size_t)b * p->batch + i];
            const uint8_t* src =
                p->images + (int64_t)idx * p->h * p->w * p->c;
            fill_sample(p, src, out.images.data() + (int64_t)i * sample_elems,
                        rng);
            out.labels[i] = p->labels ? p->labels[idx] : 0;
        }

        std::unique_lock<std::mutex> lk(p->mu);
        // the batch the consumer is waiting for must always be insertable,
        // even when the buffer is formally full, or the pipeline deadlocks
        // (consumer waits for ticket k while k's producer waits for space)
        long my_index = out.index;
        p->cv_space.wait(lk, [p, my_index] {
            return p->stopping || p->ready.size() < p->queue_cap ||
                   my_index == p->delivered;
        });
        if (p->stopping) break;
        p->ready.emplace(my_index, std::move(out));
        p->cv_ready.notify_all();
    }
}

// The consumer's copy of a finished batch out of the queue: one thread's
// memcpy sets the pace of the whole pipeline at ImageNet sizes (a 77 MB
// float32 batch), so a large copy is split over a few threads.
void copy_parallel(void* dst, const void* src, size_t bytes) {
    const int parts = bytes >= ((size_t)8 << 20) ? 4 : 1;
    const size_t chunk = (bytes / parts + 63) & ~(size_t)63;
    std::vector<std::thread> helpers;
    for (int i = 1; i < parts && (size_t)i * chunk < bytes; ++i) {
        const size_t off = (size_t)i * chunk;
        const size_t n = off + chunk < bytes ? chunk : bytes - off;
        helpers.emplace_back([=] {
            std::memcpy((char*)dst + off, (const char*)src + off, n);
        });
    }
    std::memcpy(dst, src, chunk < bytes ? chunk : bytes);
    for (auto& t : helpers) t.join();
}

// Bilinear resize, uint8 HWC -> uint8 HWC (half-pixel-centered sampling).
void resize_bilinear(const uint8_t* src, int sh, int sw, int c, uint8_t* dst,
                     int th, int tw) {
    for (int y = 0; y < th; ++y) {
        float fy = ((float)y + 0.5f) * sh / th - 0.5f;
        if (fy < 0) fy = 0;
        int y0 = (int)fy;
        int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
        float wy = fy - y0;
        for (int x = 0; x < tw; ++x) {
            float fx = ((float)x + 0.5f) * sw / tw - 0.5f;
            if (fx < 0) fx = 0;
            int x0 = (int)fx;
            int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
            float wx = fx - x0;
            const uint8_t* p00 = src + ((int64_t)y0 * sw + x0) * c;
            const uint8_t* p01 = src + ((int64_t)y0 * sw + x1) * c;
            const uint8_t* p10 = src + ((int64_t)y1 * sw + x0) * c;
            const uint8_t* p11 = src + ((int64_t)y1 * sw + x1) * c;
            uint8_t* o = dst + ((int64_t)y * tw + x) * c;
            for (int k = 0; k < c; ++k) {
                float v = (1 - wy) * ((1 - wx) * p00[k] + wx * p01[k]) +
                          wy * ((1 - wx) * p10[k] + wx * p11[k]);
                o[k] = (uint8_t)(v + 0.5f);
            }
        }
    }
}

#ifdef BT_WITH_JPEG
struct JpegErr {
    jpeg_error_mgr pub;
    jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
    longjmp(((JpegErr*)cinfo->err)->jb, 1);
}
#endif

}  // namespace

extern "C" {

// 1 when the .so was built against libjpeg (bt_decode_jpeg functional).
int bt_jpeg_available(void) {
#ifdef BT_WITH_JPEG
    return 1;
#else
    return 0;
#endif
}

// Decode a JPEG and resize — the decode half of the reference's MT input
// path (image/BGRImage.scala readRawImage + MTLabeledBGRImgToBatch), kept
// native so the whole per-sample path runs without the Python interpreter:
// libjpeg DCT scaling (scale_denom in {1,2,4,8}, decode near target size —
// the "draft mode" trick) followed by an exact bilinear resize.
//
// mode 0: scale so min(h, w) == target_h (short-side convention, train);
// mode 1: scale so the image covers (target_h, target_w) (fill, eval).
// *out is malloc'd RGB HWC (caller frees with bt_free).
// Returns 0 on success, -1 on decode error / no libjpeg at build time.
int bt_decode_jpeg(const uint8_t* buf, int64_t len, int mode, int target_h,
                   int target_w, uint8_t** out, int* out_h, int* out_w) {
#ifndef BT_WITH_JPEG
    (void)buf; (void)len; (void)mode; (void)target_h; (void)target_w;
    (void)out; (void)out_h; (void)out_w;
    return -1;
#else
    if (!buf || len <= 0 || !out || !out_h || !out_w || target_h <= 0)
        return -1;
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_err_exit;
    std::vector<uint8_t> decoded;  // declared before setjmp (longjmp and
    uint8_t* result = nullptr;     // non-trivial dtors don't mix)
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        free(result);
        return -1;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, buf, (unsigned long)len);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    const int w0 = (int)cinfo.image_width, h0 = (int)cinfo.image_height;
    if (w0 <= 0 || h0 <= 0) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    // final dims (mirrors dataset/streaming.py decode_resize's arithmetic)
    int th, tw;
    if (mode == 0) {
        const int ss = target_h;
        const double scale = (double)ss / (w0 < h0 ? w0 : h0);
        tw = (int)std::lround(w0 * scale);
        th = (int)std::lround(h0 * scale);
        if (tw < ss) tw = ss;
        if (th < ss) th = ss;
    } else {
        if (target_w <= 0) {
            jpeg_destroy_decompress(&cinfo);
            return -1;
        }
        const double scale = std::fmax((double)target_h / h0,
                                       (double)target_w / w0);
        tw = (int)std::lround(w0 * scale);
        th = (int)std::lround(h0 * scale);
        if (tw < target_w) tw = target_w;
        if (th < target_h) th = target_h;
    }
    // DCT-domain downscale: largest 1/d (d in 1,2,4,8) still >= target
    int denom = 1;
    while (denom * 2 <= 8 && w0 / (denom * 2) >= tw &&
           h0 / (denom * 2) >= th)
        denom *= 2;
    cinfo.scale_num = 1;
    cinfo.scale_denom = (unsigned)denom;
    cinfo.out_color_space = JCS_RGB;  // grayscale/YCbCr sources converted
    jpeg_start_decompress(&cinfo);
    const int dw = (int)cinfo.output_width, dh = (int)cinfo.output_height;
    if (cinfo.output_components != 3) {
        jpeg_destroy_decompress(&cinfo);
        return -1;
    }
    decoded.resize((size_t)dw * dh * 3);
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = decoded.data() + (size_t)cinfo.output_scanline * dw * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);

    result = (uint8_t*)malloc((size_t)th * tw * 3);
    if (!result) return -1;
    if (dw == tw && dh == th)
        std::memcpy(result, decoded.data(), (size_t)th * tw * 3);
    else
        resize_bilinear(decoded.data(), dh, dw, 3, result, th, tw);
    *out = result;
    *out_h = th;
    *out_w = tw;
    return 0;
#endif
}

// Create a pipeline over an in-memory uint8 image array [n, h, w, c] and
// int32 labels [n]. Caller keeps images/labels alive until destroy.
// loop=0: exactly one epoch of batches then next() returns -1.
// loop=1: endless (train mode; reshuffles each epoch, reference
//         CachedDistriDataSet train iterator semantics).
// first_ticket: the ticket of the first batch delivered (0 for a fresh
// stream; epoch * batches_per_epoch resumes at that epoch's start). A
// one-epoch pipeline (loop=0) must start at 0.
void* bt_pipeline_create_at(const uint8_t* images, int64_t n, int h, int w,
                            int c, const int32_t* labels, int batch,
                            int crop_h, int crop_w, int random_crop,
                            int hflip, const float* mean, const float* stdev,
                            int shuffle, int loop, uint64_t seed,
                            int n_threads, int queue_cap, long first_ticket) {
    if (!images || n <= 0 || batch <= 0 || crop_h <= 0 || crop_w <= 0 ||
        crop_h > h || crop_w > w || n < batch || first_ticket < 0 ||
        (!loop && first_ticket != 0))
        return nullptr;
    auto* p = new Pipeline();
    p->images = images;
    p->labels = labels;
    p->n = n;
    p->h = h;
    p->w = w;
    p->c = c;
    p->batch = batch;
    p->crop_h = crop_h;
    p->crop_w = crop_w;
    p->random_crop = random_crop != 0;
    p->hflip = hflip != 0;
    if (mean) p->mean.assign(mean, mean + c);
    else p->mean.assign(c, 0.f);
    if (stdev) p->stdev.assign(stdev, stdev + c);
    else p->stdev.assign(c, 1.f);
    p->mean_row = channel_row(p->mean.data(), c, crop_w);
    p->std_row = channel_row(p->stdev.data(), c, crop_w);
    p->shuffle = shuffle != 0;
    p->loop = loop != 0;
    p->seed = seed;
    p->batches_per_epoch = n / batch;  // drop remainder: static shapes
    p->queue_cap = queue_cap > 0 ? (size_t)queue_cap : 4;
    p->ticket = first_ticket;
    p->delivered = first_ticket;
    int nt = n_threads > 0 ? n_threads : 4;
    for (int i = 0; i < nt; ++i)
        p->workers.emplace_back(worker_main, p);
    return p;
}

void* bt_pipeline_create(const uint8_t* images, int64_t n, int h, int w,
                         int c, const int32_t* labels, int batch, int crop_h,
                         int crop_w, int random_crop, int hflip,
                         const float* mean, const float* stdev, int shuffle,
                         int loop, uint64_t seed, int n_threads,
                         int queue_cap) {
    return bt_pipeline_create_at(images, n, h, w, c, labels, batch, crop_h,
                                 crop_w, random_crop, hflip, mean, stdev,
                                 shuffle, loop, seed, n_threads, queue_cap,
                                 0);
}

long bt_pipeline_batches_per_epoch(void* h) {
    return h ? ((Pipeline*)h)->batches_per_epoch : 0;
}

// Pop the next finished batch into caller buffers
// (out_images: batch*crop_h*crop_w*c floats; out_labels: batch int32).
// Returns the batch ticket (>=0), or -1 when a non-loop pipeline is
// exhausted. Blocks while workers fill the queue.
long bt_pipeline_next(void* h, float* out_images, int32_t* out_labels) {
    auto* p = (Pipeline*)h;
    if (!p) return -1;
    std::unique_lock<std::mutex> lk(p->mu);
    if (!p->loop && p->delivered >= p->batches_per_epoch) return -1;
    // wait for the *in-order* next batch, not just any finished one
    p->cv_ready.wait(lk, [p] {
        return p->stopping || p->ready.count(p->delivered) > 0;
    });
    if (p->stopping && p->ready.count(p->delivered) == 0) return -1;
    auto it = p->ready.find(p->delivered);
    Batch b = std::move(it->second);
    p->ready.erase(it);
    p->delivered++;
    p->cv_space.notify_all();  // wake the producer of the new head ticket
    lk.unlock();
    copy_parallel(out_images, b.images.data(),
                  b.images.size() * sizeof(float));
    if (out_labels)
        std::memcpy(out_labels, b.labels.data(),
                    b.labels.size() * sizeof(int32_t));
    long index = b.index;
    p->give_buffer(std::move(b));
    return index;
}

void bt_pipeline_destroy(void* h) {
    auto* p = (Pipeline*)h;
    if (!p) return;
    {
        std::lock_guard<std::mutex> lk(p->mu);
        p->stopping = true;
    }
    p->cv_space.notify_all();
    p->cv_ready.notify_all();
    for (auto& t : p->workers) t.join();
    delete p;
}

// Streaming per-sample augment (the pixel half of the reference's
// MTLabeledBGRImgToBatch worker, image/MTLabeledBGRImgToBatch.scala:48-133):
// python worker threads decode JPEG via libjpeg (GIL released), then call
// this (GIL released by ctypes) for crop+flip+normalize — so the whole
// per-sample path runs parallel across the decode pool. Offsets/flip are
// chosen by the caller (per-sample seeded RNG lives host-side for
// reproducibility).
// Returns 1 on success, 0 when the crop window falls outside the source
// (caller must raise — silently leaving dst uninitialized would feed
// garbage batches to training).
int bt_augment_sample(const uint8_t* src, int src_h, int src_w, int c,
                      float* dst, int crop_h, int crop_w, int off_h,
                      int off_w, int flip, const float* mean,
                      const float* stdev) {
    if (!src || !dst || off_h < 0 || off_w < 0 || crop_h + off_h > src_h ||
        crop_w + off_w > src_w)
        return 0;
    augment_core(src, src_w, c, dst, crop_h, crop_w, off_h, off_w,
                 flip != 0, channel_row(mean, c, crop_w).data(),
                 channel_row(stdev, c, crop_w).data());
    return 1;
}

// ---------------------------------------------------------------- readers

// Read an MNIST idx file (the raw ubyte format the reference's
// models/lenet/Utils.scala parses). Returns element count and fills dims;
// data is malloc'd into *out (caller frees with bt_free).
int64_t bt_read_idx(const char* path, uint8_t** out, int64_t* dims,
                    int* ndim) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    uint8_t magic[4];
    // header: 0x00 0x00 <dtype> <ndim>; only ubyte (0x08) is supported and
    // ndim is capped at the caller's 8-slot dims buffer — both are
    // file-controlled bytes and must be validated, not trusted
    if (fread(magic, 1, 4, f) != 4 || magic[0] != 0 || magic[1] != 0 ||
        magic[2] != 0x08 || magic[3] == 0 || magic[3] > 8) {
        fclose(f);
        return -1;
    }
    int nd = magic[3];
    int64_t total = 1;
    for (int i = 0; i < nd; ++i) {
        uint8_t b[4];
        if (fread(b, 1, 4, f) != 4) {
            fclose(f);
            return -1;
        }
        dims[i] = ((int64_t)b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3];
        if (dims[i] <= 0 || total > (int64_t)1 << 40) {
            fclose(f);
            return -1;
        }
        total *= dims[i];
    }
    *ndim = nd;
    *out = (uint8_t*)malloc((size_t)total);
    if (!*out) {
        fclose(f);
        return -1;
    }
    int64_t got = (int64_t)fread(*out, 1, (size_t)total, f);
    fclose(f);
    if (got != total) {
        free(*out);
        *out = nullptr;
        return -1;
    }
    return total;
}

// Read one CIFAR-10 .bin shard (reference dataset format: records of
// 1 label byte + 3072 CHW pixel bytes). Fills images as NHWC uint8.
int64_t bt_read_cifar10(const char* path, uint8_t* images, int32_t* labels,
                        int64_t max_records) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    const int hw = 32 * 32;
    std::vector<uint8_t> rec(1 + 3 * hw);
    int64_t count = 0;
    while (count < max_records &&
           fread(rec.data(), 1, rec.size(), f) == rec.size()) {
        labels[count] = rec[0];
        uint8_t* dst = images + count * (int64_t)(3 * hw);
        // CHW (RGB planes) -> HWC
        for (int i = 0; i < hw; ++i) {
            dst[i * 3 + 0] = rec[1 + i];
            dst[i * 3 + 1] = rec[1 + hw + i];
            dst[i * 3 + 2] = rec[1 + 2 * hw + i];
        }
        ++count;
    }
    fclose(f);
    return count;
}

void bt_free(void* p) { free(p); }

}  // extern "C"
