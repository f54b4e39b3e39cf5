// Native FASTA reader: file/gz -> sentinel-separated base buffer.
//
// The reference's input layer is a Python generator chain over text lines
// (reference src/krisp/kstream/kstream.py:458-583); at GB scale that
// is the irreducibly serial bottleneck feeding the device.  This reader
// scans bytes once (zlib for .gz), strips headers/newlines, and emits the
// exact buffer layout the device kernels consume: record sequences
// separated by single NUL sentinel bytes.
//
// Exposed via ctypes (no pybind11 in this environment):
//   KBuf* kfasta_read(const char* path)
//   void  kbuf_free(KBuf*)
// KBuf layout must stay in sync with io/native.py.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <zlib.h>

extern "C" {

struct KBuf {
    uint8_t* data;
    size_t len;
    size_t n_records;
};

struct KBufImpl {
    KBuf pub;
    std::vector<uint8_t> storage;
};

KBuf* kfasta_read(const char* path) {
    gzFile f = gzopen(path, "rb");  // zlib reads plain files transparently
    if (!f) return nullptr;
    gzbuffer(f, 1 << 20);

    auto* impl = new KBufImpl();
    std::vector<uint8_t>& out = impl->storage;
    out.reserve(1 << 20);

    const size_t CHUNK = 1 << 20;
    std::vector<uint8_t> buf(CHUNK);
    bool in_header = false;
    bool fasta_mode = false;
    bool at_line_start = true;
    bool first_content = true;
    size_t n_records = 0;

    int got;
    while ((got = gzread(f, buf.data(), CHUNK)) > 0) {
        for (int i = 0; i < got; ++i) {
            uint8_t c = buf[i];
            if (c == '\n' || c == '\r') {
                if (in_header) in_header = false;
                at_line_start = (c == '\n') || at_line_start;
                if (c == '\n') at_line_start = true;
                continue;
            }
            if (at_line_start && c == '>') {
                if (first_content) fasta_mode = true;
                first_content = false;
                in_header = true;
                at_line_start = false;
                if (!out.empty() && out.back() != 0) out.push_back(0);
                ++n_records;
                continue;
            }
            if (at_line_start && !fasta_mode && !first_content) {
                // raw-line mode: every line is its own record
                if (!out.empty() && out.back() != 0) out.push_back(0);
                ++n_records;
            }
            if (first_content) {
                first_content = false;
                if (!fasta_mode) ++n_records;
            }
            at_line_start = false;
            if (in_header) continue;
            if (c == ' ' || c == '\t') continue;
            out.push_back(c);
        }
    }
    gzclose(f);
    if (!out.empty() && out.back() != 0) out.push_back(0);

    impl->pub.data = out.data();
    impl->pub.len = out.size();
    impl->pub.n_records = n_records;
    return &impl->pub;
}

void kbuf_free(KBuf* b) {
    if (!b) return;
    // KBuf is the first member of KBufImpl, so the pointers coincide
    delete reinterpret_cast<KBufImpl*>(b);
}

}  // extern "C"
