// Native IO codecs for the SCV-OD engine.
//
// Replaces the reference's IO-bound native code paths with standalone C++
// (no ROS/PCL): KITTI .bin/.label decode (reference: src/ssc.cpp:1046-1058
// reads them with ifstream into vectors) and binary PCD read/write
// (reference: pcl::io::savePCDFile / loadPCDFile via utility.h:408-430).
//
// Exposed as a C ABI for ctypes (pybind11 is not available in this image).
// mmap-based zero-copy reads; all functions return 0 on success.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// KITTI velodyne .bin: N * 4 float32 (x, y, z, intensity)
// ---------------------------------------------------------------------------

// Returns the number of points, or -1 on error.
int64_t kitti_bin_num_points(const char* path) {
    struct stat st;
    if (stat(path, &st) != 0) return -1;
    return st.st_size / (4 * sizeof(float));
}

// out must hold n*4 floats (n from kitti_bin_num_points).
int kitti_bin_read(const char* path, float* out, int64_t n) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return 1;
    size_t bytes = static_cast<size_t>(n) * 4 * sizeof(float);
    void* m = mmap(nullptr, bytes, PROT_READ, MAP_PRIVATE, fd, 0);
    if (m == MAP_FAILED) { close(fd); return 2; }
    std::memcpy(out, m, bytes);
    munmap(m, bytes);
    close(fd);
    return 0;
}

// ---------------------------------------------------------------------------
// SemanticKITTI .label: N * uint32 (semantic = low 16 bits, instance = high)
// ---------------------------------------------------------------------------

int64_t kitti_label_num_points(const char* path) {
    struct stat st;
    if (stat(path, &st) != 0) return -1;
    return st.st_size / sizeof(uint32_t);
}

int kitti_label_read(const char* path, uint32_t* out, int64_t n) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return 1;
    size_t bytes = static_cast<size_t>(n) * sizeof(uint32_t);
    void* m = mmap(nullptr, bytes, PROT_READ, MAP_PRIVATE, fd, 0);
    if (m == MAP_FAILED) { close(fd); return 2; }
    std::memcpy(out, m, bytes);
    munmap(m, bytes);
    close(fd);
    return 0;
}

// ---------------------------------------------------------------------------
// Binary PCD, fields x y z intensity (float32) - the artifact format the
// reference writes per frame (seg/<id>.pcd etc., src/ssc.cpp:556).
// ---------------------------------------------------------------------------

int pcd_write_xyzi(const char* path, const float* xyzi, int64_t n) {
    FILE* f = fopen(path, "wb");
    if (!f) return 1;
    fprintf(f,
            "# .PCD v0.7 - Point Cloud Data file format\n"
            "VERSION 0.7\n"
            "FIELDS x y z intensity\n"
            "SIZE 4 4 4 4\n"
            "TYPE F F F F\n"
            "COUNT 1 1 1 1\n"
            "WIDTH %lld\nHEIGHT 1\n"
            "VIEWPOINT 0 0 0 1 0 0 0\n"
            "POINTS %lld\nDATA binary\n",
            static_cast<long long>(n), static_cast<long long>(n));
    size_t wrote = fwrite(xyzi, sizeof(float) * 4, n, f);
    fclose(f);
    return wrote == static_cast<size_t>(n) ? 0 : 2;
}

// Parses the header of a binary xyzi PCD; returns n or -1.
int64_t pcd_num_points(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    char line[512];
    int64_t n = -1;
    while (fgets(line, sizeof line, f)) {
        if (std::strncmp(line, "POINTS", 6) == 0) {
            n = atoll(line + 6);
        }
        if (std::strncmp(line, "DATA", 4) == 0) break;
    }
    fclose(f);
    return n;
}

int pcd_read_xyzi(const char* path, float* out, int64_t n) {
    FILE* f = fopen(path, "rb");
    if (!f) return 1;
    char line[512];
    bool binary = false;
    int n_fields = 0;
    while (fgets(line, sizeof line, f)) {
        if (std::strncmp(line, "FIELDS", 6) == 0) {
            const char* p = line + 6;
            while (*p) { if (*p == ' ') n_fields++; p++; }
        }
        if (std::strncmp(line, "DATA", 4) == 0) {
            binary = std::strstr(line, "binary") != nullptr;
            break;
        }
    }
    if (!binary || n_fields < 3) { fclose(f); return 3; }
    if (n_fields == 4) {
        size_t got = fread(out, sizeof(float) * 4, n, f);
        fclose(f);
        return got == static_cast<size_t>(n) ? 0 : 2;
    }
    // generic: read n_fields floats per point, keep first 4 (pad intensity)
    std::vector<float> row(n_fields);
    for (int64_t i = 0; i < n; i++) {
        if (fread(row.data(), sizeof(float), n_fields, f)
            != static_cast<size_t>(n_fields)) { fclose(f); return 2; }
        out[i * 4 + 0] = row[0];
        out[i * 4 + 1] = row[1];
        out[i * 4 + 2] = row[2];
        out[i * 4 + 3] = n_fields > 3 ? row[3] : 0.0f;
    }
    fclose(f);
    return 0;
}

// ---------------------------------------------------------------------------
// Asynchronous sequence prefetcher: a background thread decodes scans
// (.bin + optional .label) AHEAD of the consumer into a bounded ring of
// fixed-capacity slots, so file IO overlaps device compute. The reference's
// driver loop reads every scan synchronously between processing steps
// (src/ssc.cpp:1046-1058 inside the per-frame loop); here the engine's
// feed() loop pops decoded scans with zero stall in the steady state.
// ---------------------------------------------------------------------------

}  // extern "C"  (reopened below; the prefetcher needs C++ internals)

#include <condition_variable>
#include <mutex>
#include <thread>

namespace {

struct Slot {
    std::vector<float> pts;        // [cap*4]
    std::vector<uint32_t> labels;  // [cap] (zeros when no label file)
    int64_t n = 0;                 // points decoded (clamped to cap)
    int64_t total = 0;             // points in the file (pre-clamp)
    int rc = 0;                    // decode status, 0 = ok
};

struct Prefetcher {
    std::vector<std::string> bins, labs;   // labs[i] empty = no label file
    int64_t cap;                           // max points per slot
    size_t depth;                          // ring capacity
    std::vector<Slot> ring;
    size_t head = 0, tail = 0, count = 0;  // ring state (tail = next pop)
    std::mutex mu;
    std::condition_variable cv_push, cv_pop;
    bool stop = false;
    std::thread worker;

    void run() {
        for (size_t i = 0; i < bins.size(); i++) {
            Slot s;
            s.pts.resize(cap * 4);
            s.total = kitti_bin_num_points(bins[i].c_str());
            if (s.total < 0) {
                s.rc = 1;
            } else {
                s.n = s.total < cap ? s.total : cap;
                // read only the first n points (mmap window)
                int fd = open(bins[i].c_str(), O_RDONLY);
                if (fd < 0) { s.rc = 1; }
                else {
                    size_t bytes = static_cast<size_t>(s.total) * 16;
                    void* m = mmap(nullptr, bytes, PROT_READ, MAP_PRIVATE,
                                   fd, 0);
                    if (m == MAP_FAILED) { s.rc = 2; }
                    else {
                        std::memcpy(s.pts.data(), m,
                                    static_cast<size_t>(s.n) * 16);
                        munmap(m, bytes);
                    }
                    close(fd);
                }
            }
            if (s.rc == 0 && !labs[i].empty()) {
                s.labels.resize(cap);
                int64_t ln = kitti_label_num_points(labs[i].c_str());
                if (ln != s.total) { s.rc = 3; }  // scan/label mismatch
                else {
                    std::vector<uint32_t> full(ln);
                    int rc = kitti_label_read(labs[i].c_str(), full.data(),
                                              ln);
                    if (rc != 0) s.rc = 10 + rc;
                    else std::memcpy(s.labels.data(), full.data(),
                                     static_cast<size_t>(s.n) * 4);
                }
            }
            std::unique_lock<std::mutex> lk(mu);
            cv_push.wait(lk, [&] { return count < depth || stop; });
            if (stop) return;
            ring[head] = std::move(s);
            head = (head + 1) % depth;
            count++;
            cv_pop.notify_one();
        }
    }
};

}  // namespace

extern "C" {

// Returns an opaque handle. label_paths may be null (no labels) and
// individual entries may be empty strings.
void* prefetch_open(const char** bin_paths, const char** label_paths,
                    int64_t n_files, int64_t max_points, int depth) {
    if (n_files <= 0 || max_points <= 0 || depth <= 0) return nullptr;
    auto* p = new Prefetcher();
    p->cap = max_points;
    p->depth = static_cast<size_t>(depth);
    p->ring.resize(p->depth);
    for (int64_t i = 0; i < n_files; i++) {
        p->bins.emplace_back(bin_paths[i]);
        p->labs.emplace_back(
            label_paths && label_paths[i] ? label_paths[i] : "");
    }
    p->worker = std::thread([p] { p->run(); });
    return p;
}

// Blocks until the next scan (in file order) is decoded, copies up to
// max_points rows into out_pts [max_points*4] / out_labels [max_points]
// (out_labels may be null). Returns the file's TOTAL point count (so the
// caller can detect clamping), or -rc on a decode error for that file.
// Never returns 0 for an empty ring - it blocks; call exactly n_files
// times.
int64_t prefetch_next(void* h, float* out_pts, uint32_t* out_labels,
                      int64_t max_points) {
    auto* p = static_cast<Prefetcher*>(h);
    Slot s;
    {
        std::unique_lock<std::mutex> lk(p->mu);
        p->cv_pop.wait(lk, [&] { return p->count > 0; });
        s = std::move(p->ring[p->tail]);
        p->tail = (p->tail + 1) % p->depth;
        p->count--;
        p->cv_push.notify_one();
    }
    if (s.rc != 0) return -s.rc;
    int64_t n = s.n < max_points ? s.n : max_points;
    std::memcpy(out_pts, s.pts.data(), static_cast<size_t>(n) * 16);
    if (out_labels && !s.labels.empty())
        std::memcpy(out_labels, s.labels.data(),
                    static_cast<size_t>(n) * 4);
    else if (out_labels)
        std::memset(out_labels, 0, static_cast<size_t>(n) * 4);
    return s.total;
}

void prefetch_close(void* h) {
    auto* p = static_cast<Prefetcher*>(h);
    {
        std::lock_guard<std::mutex> lk(p->mu);
        p->stop = true;
        p->cv_push.notify_all();
    }
    if (p->worker.joinable()) p->worker.join();
    delete p;
}

}  // extern "C"
