// Native DNA codec of the PyTorch port: the host encode hot path, C++ twin
// of cpgisland_tpu_torch/utils/codec.py's NumPy paths.
//
// The reference's IO layer is a JVM char-by-char stream (CpGIslandFinder.java
// :112-128,:238-254 — BufferedReader.read() per character).  Here the host-side
// encode runs as a single fused pass over raw bytes: FASTA-header stripping
// (optional) + 256-entry LUT symbol mapping + compaction, with streaming state
// carried across arbitrary buffer boundaries so multi-GiB genomes encode in
// bounded memory.  A copy of the JAX package's native/codec.cpp, built and
// loaded on its own: a plain C interface, loaded with ctypes.  The NumPy path
// stays as the parity oracle in the tests.
//
// A host library, not a kernel: built at first use by
// cpgisland_tpu_torch/utils/native.py with
// `g++ -O3 -std=c++17 -fPIC -pthread -shared` into build/torch_native/.

#include <cstddef>
#include <cstring>
#include <cstdint>

namespace {

// LUT: A/a->0 C/c->1 G/g->2 T/t->3, everything else -> 0xFF (skip).
// Matches cpgisland_tpu_torch/utils/codec.py::_LUT and the reference's char mapping.
struct Lut {
    uint8_t t[256];
    constexpr Lut() : t() {
        for (int i = 0; i < 256; ++i) t[i] = 0xFF;
        t['A'] = t['a'] = 0;
        t['C'] = t['c'] = 1;
        t['G'] = t['g'] = 2;
        t['T'] = t['t'] = 3;
    }
};
constexpr Lut kLut;

}  // namespace

extern "C" {

// Encode n raw bytes into out (caller-sized >= n); returns symbols written.
// Reference semantics: every non-ACGTacgt byte silently skipped.
size_t cpg_encode(const uint8_t* in, size_t n, uint8_t* out) {
    size_t w = 0;
    for (size_t i = 0; i < n; ++i) {
        uint8_t v = kLut.t[in[i]];
        out[w] = v;
        w += (v != 0xFF);  // branchless compaction
    }
    return w;
}

// Streaming-state bits for the FASTA-aware path (mirrors
// codec._strip_headers_stateful's (in_header, at_line_start) carry).
enum : uint32_t {
    kInHeader = 1u << 0,
    kAtLineStart = 1u << 1,
};

// Fused header-strip + encode.  *state carries (in_header, at_line_start)
// across buffer boundaries; initialize to kAtLineStart (2) for a fresh file.
// A header opens only at a '>' that begins a line and runs to end-of-line.
//
// Line-span structure: memchr jumps between newlines so the inner encode loop
// is the same tight LUT/compaction loop as cpg_encode, with the header/'>'
// checks hoisted out to once per line ('>' mid-line is not a base, so the LUT
// skips it either way — only the line-start check changes behavior).
size_t cpg_encode_fasta(const uint8_t* in, size_t n, uint8_t* out, uint32_t* state) {
    bool in_header = *state & kInHeader;
    bool at_line_start = *state & kAtLineStart;
    size_t w = 0;
    size_t i = 0;
    while (i < n) {
        if (in_header) {
            const void* nl = memchr(in + i, '\n', n - i);
            if (!nl) {
                i = n;
                at_line_start = false;
                break;
            }
            i = static_cast<size_t>(static_cast<const uint8_t*>(nl) - in) + 1;
            in_header = false;
            at_line_start = true;
            continue;
        }
        if (at_line_start && in[i] == '>') {
            in_header = true;
            continue;
        }
        const void* nl = memchr(in + i, '\n', n - i);
        size_t end = nl ? static_cast<size_t>(static_cast<const uint8_t*>(nl) - in) : n;
        for (size_t j = i; j < end; ++j) {
            uint8_t v = kLut.t[in[j]];
            out[w] = v;
            w += (v != 0xFF);
        }
        if (nl) {
            i = end + 1;
            at_line_start = true;
        } else {
            i = n;
            at_line_start = false;
        }
    }
    *state = (in_header ? kInHeader : 0u) | (at_line_start ? kAtLineStart : 0u);
    return w;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Parallel whole-buffer encode.
//
// The streaming kernels above are single-threaded (bounded memory, arbitrary
// block boundaries).  For whole-file encodes the host is the bottleneck at
// GRCh38 scale (~3 GiB), so this path fans out across threads in two phases:
// each thread counts its segment's symbols (phase 1), a tiny serial prefix
// sum fixes every segment's exact output offset, then each thread re-scans
// and writes (phase 2).  Output is dense with no compaction pass, and the
// caller allocates exactly sum(counts) bytes between the phases
// (cpg_count_segments / cpg_encode_segments).
//
// FASTA mode requires segment-local header state, so segments are aligned to
// line starts (headers never span lines); byte-aligned otherwise.

#include <algorithm>
#include <thread>
#include <vector>

namespace {

// One segment's fused strip+encode, counting always, writing when out != nullptr.
// Segment must begin at a line start in FASTA mode.
template <bool Fasta>
size_t segment_pass(const uint8_t* in, size_t begin, size_t end, uint8_t* out) {
    size_t w = 0;
    size_t i = begin;
    bool in_header = false;
    while (i < end) {
        if (Fasta) {
            if (in_header) {
                const void* nl = memchr(in + i, '\n', end - i);
                if (!nl) break;
                i = static_cast<size_t>(static_cast<const uint8_t*>(nl) - in) + 1;
                in_header = false;
                continue;
            }
            if (in[i] == '>') {  // loop invariant: i is at a line start here
                in_header = true;
                continue;
            }
        }
        const void* nl = memchr(in + i, '\n', end - i);
        size_t stop = nl ? static_cast<size_t>(static_cast<const uint8_t*>(nl) - in) : end;
        for (size_t j = i; j < stop; ++j) {
            uint8_t v = kLut.t[in[j]];
            // NOT the streaming kernels' speculative store: segments here are
            // exactly sized, so a sentinel written at out[w] would land in the
            // next thread's region (or past the buffer on the last segment).
            if (v != 0xFF) {
                if (out) out[w] = v;
                ++w;
            }
        }
        i = nl ? stop + 1 : end;
    }
    return w;
}

// Non-FASTA mode has no line structure to respect: one tight loop.
size_t segment_pass_raw(const uint8_t* in, size_t begin, size_t end, uint8_t* out) {
    size_t w = 0;
    for (size_t i = begin; i < end; ++i) {
        uint8_t v = kLut.t[in[i]];
        if (v != 0xFF) {  // no speculative store: exact-sized segment regions
            if (out) out[w] = v;
            ++w;
        }
    }
    return w;
}

std::vector<size_t> segment_bounds(const uint8_t* in, size_t n, int fasta, int nthreads) {
    size_t k = static_cast<size_t>(nthreads);
    std::vector<size_t> b;
    b.push_back(0);
    for (size_t t = 1; t < k; ++t) {
        size_t pos = n * t / k;
        if (pos <= b.back()) continue;
        if (fasta) {
            // Align to the next line start so header state is segment-local.
            const void* nl = memchr(in + pos, '\n', n - pos);
            if (!nl) break;
            pos = static_cast<size_t>(static_cast<const uint8_t*>(nl) - in) + 1;
            if (pos <= b.back() || pos >= n) continue;
        }
        b.push_back(pos);
    }
    b.push_back(n);
    return b;
}

int resolve_threads(int nthreads, size_t n) {
    if (nthreads <= 0) {
        unsigned hw = std::thread::hardware_concurrency();
        nthreads = hw ? static_cast<int>(hw) : 4;
    }
    // Below ~4 MiB per thread the spawn/join overhead beats the win.
    size_t cap = std::max<size_t>(1, n / (4u << 20));
    return static_cast<int>(std::min<size_t>(static_cast<size_t>(nthreads), cap));
}

}  // namespace

extern "C" {

// Phase 1: compute segment bounds and per-segment symbol counts.  bounds_out
// needs max_seg + 1 entries, counts_out max_seg; returns the segment count
// (0 when n == 0 or max_seg is too small for even one segment).
size_t cpg_count_segments(const uint8_t* in, size_t n, int fasta, int nthreads,
                          size_t* bounds_out, size_t* counts_out, size_t max_seg) {
    if (n == 0 || max_seg == 0) return 0;
    nthreads = resolve_threads(nthreads, n);
    if (static_cast<size_t>(nthreads) > max_seg) nthreads = static_cast<int>(max_seg);
    std::vector<size_t> bounds = segment_bounds(in, n, fasta, nthreads);
    size_t nseg = bounds.size() - 1;
    if (nseg > max_seg) return 0;
    std::vector<size_t> counts(nseg, 0);
    std::vector<std::thread> ts;
    auto count_one = [&](size_t s) {
        counts[s] = fasta ? segment_pass<true>(in, bounds[s], bounds[s + 1], nullptr)
                          : segment_pass_raw(in, bounds[s], bounds[s + 1], nullptr);
    };
    for (size_t s = 1; s < nseg; ++s) ts.emplace_back(count_one, s);
    count_one(0);
    for (auto& t : ts) t.join();
    for (size_t s = 0; s <= nseg; ++s) bounds_out[s] = bounds[s];
    for (size_t s = 0; s < nseg; ++s) counts_out[s] = counts[s];
    return nseg;
}

// Phase 2: write using phase 1's bounds/counts; out needs capacity for
// exactly sum(counts).  Returns symbols written.
size_t cpg_encode_segments(const uint8_t* in, const size_t* bounds, const size_t* counts,
                           size_t nseg, int fasta, uint8_t* out) {
    if (nseg == 0) return 0;
    std::vector<size_t> offsets(nseg, 0);
    for (size_t s = 1; s < nseg; ++s) offsets[s] = offsets[s - 1] + counts[s - 1];
    std::vector<std::thread> ts;
    auto write_one = [&](size_t s) {
        if (fasta) {
            segment_pass<true>(in, bounds[s], bounds[s + 1], out + offsets[s]);
        } else {
            segment_pass_raw(in, bounds[s], bounds[s + 1], out + offsets[s]);
        }
    };
    for (size_t s = 1; s < nseg; ++s) ts.emplace_back(write_one, s);
    write_one(0);
    for (auto& t : ts) t.join();
    return offsets[nseg - 1] + counts[nseg - 1];
}

// ABI version guard so a stale .so is rejected by the loader (the port's
// own constant: utils/native.py's _ABI).
uint32_t cpg_native_abi(void) { return 101; }

}  // extern "C"
