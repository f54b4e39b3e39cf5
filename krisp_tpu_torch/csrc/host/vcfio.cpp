// Native VCF tokenizer: file/gz -> columnar arrays.
//
// Replaces the htslib/pysam layer of the reference
// (reference src/krisp/krisp_vcf/krisp_vcf.py:1185-1189) and the
// Python line parser fallback: one byte scan (zlib inflate for .gz)
// producing struct-of-arrays ready for the vectorized classification
// kernel — DP/GQ int32 per (record, sample), AD int32 per (record, sample,
// allele<=MAX_ALLELES), QUAL/MQ per record, allele strings in a shared
// blob with offsets.
//
// Exposed via ctypes (layout must stay in sync with io/native_vcf.py):
//   KVcf* kvcf_read(const char* path, int max_alleles)
//   KVcf* kvcf_read_range(const char* path, int max_alleles,
//                         int64_t start_off, int64_t end_off)
//   KVcf* kvcf_read_anchored(const char* path, int max_alleles,
//                            const int64_t* anchors,
//                            const int64_t* row_starts, int n_spans)
//     — threaded parse of a PLAIN file: span i = [anchors[i],
//     anchors[i+1]) parses on its own thread, writing the bulk
//     (rows x samples[ x alleles]) arrays in place at row_starts[i];
//     element-identical to the sequential parse, ~Nx the throughput.
//   KIdx* kvcf_index(const char* path, const char* out_plain)
//   void  kvcf_free(KVcf*) / kvcf_index_free(KIdx*)
//
// kvcf_read_range parses only records whose line starts in
// [start_off, end_off) of the (decompressed) byte stream — the header is
// always read from the top for sample names.  end_off < 0 means EOF.
// Offsets come from krisp_tpu's VcfOffsetIndex (built over the plain
// decompressed file), giving O(range) slice loads with memory bounded by
// the slice instead of the file.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <string>
#include <string_view>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

struct KVcf {
    // header
    char* sample_blob;        // sample names, NUL separated
    size_t sample_blob_len;
    int32_t n_samples;
    // records
    int64_t n_records;
    int32_t max_alleles;
    int64_t* pos;             // [n_records] 1-based POS
    double* qual;             // [n_records]; NaN for '.'
    double* mq;               // [n_records]; NaN when absent
    int32_t* n_alleles;       // [n_records]
    int32_t* chrom_id;        // [n_records] index into chrom_blob order
    char* chrom_blob;         // distinct chrom names, NUL separated
    size_t chrom_blob_len;
    char* allele_blob;        // allele strings, NUL separated, in record order
    size_t allele_blob_len;
    int64_t* allele_off;      // [n_records] first allele index of record
    int64_t n_allele_strings;
    int32_t* dp;              // [n_records * n_samples]; -1 missing
    int32_t* gq;              // [n_records * n_samples]; -1 missing
    int32_t* ad;              // [n_records * n_samples * max_alleles]; 0 missing
    int32_t* rlen;            // [n_records] REF allele length
    int32_t* alen;            // [n_records * max_alleles] allele length;
                              // '*' counts 0, padding -1
};

struct KVcfImpl {
    KVcf pub;
    std::string sample_blob, chrom_blob, allele_blob;
    std::vector<int64_t> pos, allele_off;
    std::vector<double> qual, mq;
    std::vector<int32_t> n_alleles, chrom_id, dp, gq, ad, rlen, alen;
};

static bool read_line(gzFile f, std::string& line) {
    line.clear();
    char buf[1 << 16];
    while (gzgets(f, buf, sizeof buf)) {
        line += buf;
        if (!line.empty() && line.back() == '\n') {
            line.pop_back();
            if (!line.empty() && line.back() == '\r') line.pop_back();
            return true;
        }
    }
    return !line.empty();
}

static void split(const std::string& s, char sep,
                  std::vector<std::string>& out) {
    out.clear();
    size_t start = 0;
    while (true) {
        size_t p = s.find(sep, start);
        if (p == std::string::npos) {
            out.push_back(s.substr(start));
            return;
        }
        out.push_back(s.substr(start, p - start));
        start = p + 1;
    }
}

// in-place tokenization: views into the line buffer, zero copies (the
// sample-field split dominated the parse at 100+ samples per record)
static void split_sv(std::string_view s, char sep,
                     std::vector<std::string_view>& out) {
    out.clear();
    size_t start = 0;
    while (true) {
        size_t p = s.find(sep, start);
        if (p == std::string_view::npos) {
            out.push_back(s.substr(start));
            return;
        }
        out.push_back(s.substr(start, p - start));
        start = p + 1;
    }
}

// numeric views point into the NUL-terminated line buffer, so strtol/
// strtod stop at the following delimiter without overrunning
static int32_t sv_i32(std::string_view t) {
    if (t.empty() || t == ".") return -1;
    return (int32_t)strtol(t.data(), nullptr, 10);
}

// Parse the header only: sample names into ``sample_blob`` and the byte
// offset of the first post-#CHROM line into ``header_end``.  Fails on a
// record line before #CHROM (same contract as the original one-pass loop).
static bool parse_header(const char* path, std::string& sample_blob,
                         int& n_samples, int64_t& header_end) {
    gzFile f = gzopen(path, "rb");
    if (!f) return false;
    gzbuffer(f, 1 << 20);
    std::string line;
    std::vector<std::string> fields;
    n_samples = 0;
    bool done = false;
    while (!done) {
        if (!read_line(f, line)) break;
        if (line.empty()) continue;
        if (line[0] != '#') { gzclose(f); return false; }
        if (line.rfind("#CHROM", 0) == 0) {
            split(line, '\t', fields);
            for (size_t i = 9; i < fields.size(); ++i) {
                sample_blob += fields[i];
                sample_blob += '\0';
                ++n_samples;
            }
            done = true;
        }
    }
    header_end = (int64_t)gztell(f);
    gzclose(f);
    return done;
}

// Per-thread scratch for the field tokenizers (reused across lines so the
// vectors stop reallocating after the first few records).
struct ParseScratch {
    std::vector<std::string_view> fsv, fmt, toks, adtoks, alts;
};

// Direct-write destination for the (records x samples[ x alleles]) bulk
// arrays: the anchored parallel path preallocates them once and each
// thread fills its own row range in place — no post-merge copy of the
// GB-scale genotype cube.  Null = append to impl's vectors (single-span).
struct DirectOut {
    int32_t* dp;
    int32_t* gq;
    int32_t* ad;
    int64_t row;              // next absolute row to write
};

static void parse_record_line(std::string_view line, int max_alleles,
                              int n_samples,
                              std::vector<std::string>& chroms,
                              KVcfImpl* impl, ParseScratch& sc,
                              DirectOut* dout = nullptr) {
    auto& fsv = sc.fsv;
    auto& fmt = sc.fmt;
    auto& toks = sc.toks;
    auto& adtoks = sc.adtoks;
    auto& alts = sc.alts;
    split_sv(line, '\t', fsv);
        if (fsv.size() < 8) return;

        // CHROM interning
        int32_t cid = -1;
        for (size_t i = 0; i < chroms.size(); ++i)
            if (chroms[i] == fsv[0]) { cid = (int32_t)i; break; }
        if (cid < 0) {
            cid = (int32_t)chroms.size();
            chroms.emplace_back(fsv[0]);
            impl->chrom_blob += fsv[0];
            impl->chrom_blob += '\0';
        }
        impl->chrom_id.push_back(cid);
        impl->pos.push_back(strtoll(fsv[1].data(), nullptr, 10));

        // alleles: REF + ALTs
        impl->allele_off.push_back(
            (int64_t)impl->n_alleles.size() == 0
                ? 0
                : impl->allele_off.back() + impl->n_alleles.back());
        int32_t na = 1;
        impl->allele_blob += fsv[3];
        impl->allele_blob += '\0';
        impl->rlen.push_back((int32_t)fsv[3].size());
        impl->alen.resize(impl->alen.size() + max_alleles, -1);
        int32_t* arow = impl->alen.data() + impl->alen.size() - max_alleles;
        if (max_alleles > 0)
            arow[0] = (fsv[3] == "*") ? 0 : (int32_t)fsv[3].size();
        if (fsv[4] != "." && !fsv[4].empty()) {
            split_sv(fsv[4], ',', alts);
            for (auto a : alts) {
                impl->allele_blob += a;
                impl->allele_blob += '\0';
                if (na < max_alleles)
                    arow[na] = (a == "*") ? 0 : (int32_t)a.size();
                ++na;
            }
        }
        impl->n_alleles.push_back(na);

        impl->qual.push_back(fsv[5] == "." ? NAN
                             : strtod(fsv[5].data(), nullptr));
        double mqv = NAN;
        std::string_view info = fsv[7];
        size_t mp = 0;
        while (true) {
            mp = info.find("MQ=", mp);
            if (mp == std::string_view::npos) break;
            if (mp == 0 || info[mp - 1] == ';') {
                mqv = strtod(info.data() + mp + 3, nullptr);
                break;
            }
            ++mp;
        }
        impl->mq.push_back(mqv);

        // FORMAT indices
        int dpi = -1, gqi = -1, adi = -1;
        if (fsv.size() > 8) {
            split_sv(fsv[8], ':', fmt);
            for (size_t i = 0; i < fmt.size(); ++i) {
                if (fmt[i] == "DP") dpi = (int)i;
                else if (fmt[i] == "GQ") gqi = (int)i;
                else if (fmt[i] == "AD") adi = (int)i;
            }
        }
        int32_t* ad_row;
        int32_t* dp_row;
        int32_t* gq_row;
        if (dout) {
            ad_row = dout->ad + dout->row * (int64_t)n_samples * max_alleles;
            dp_row = dout->dp + dout->row * (int64_t)n_samples;
            gq_row = dout->gq + dout->row * (int64_t)n_samples;
            ++dout->row;
        } else {
            size_t ad_base = impl->ad.size();
            impl->ad.resize(ad_base + (size_t)n_samples * max_alleles, 0);
            ad_row = impl->ad.data() + ad_base;
            size_t sb = impl->dp.size();
            impl->dp.resize(sb + n_samples);
            impl->gq.resize(sb + n_samples);
            dp_row = impl->dp.data() + sb;
            gq_row = impl->gq.data() + sb;
        }
        for (int s = 0; s < n_samples; ++s, ad_row += max_alleles) {
            int32_t dv = -1, gv = -1;
            size_t col = 9 + s;
            if (col < fsv.size()) {
                split_sv(fsv[col], ':', toks);
                if (dpi >= 0 && dpi < (int)toks.size()) dv = sv_i32(toks[dpi]);
                if (gqi >= 0 && gqi < (int)toks.size()) gv = sv_i32(toks[gqi]);
                if (adi >= 0 && adi < (int)toks.size() && toks[adi] != ".") {
                    split_sv(toks[adi], ',', adtoks);
                    for (int a = 0; a < (int)adtoks.size() && a < max_alleles;
                         ++a) {
                        int32_t v = sv_i32(adtoks[a]);
                        ad_row[a] = v < 0 ? 0 : v;
                    }
                }
            }
            dp_row[s] = dv;
            gq_row[s] = gv;
        }
}

// Parse record lines whose start lies in [start_off, end_off) into
// ``impl``'s record vectors (sample_blob untouched).  ``chroms`` is this
// call's interning table (callers merge/remap when combining spans).
// Thread-safe: touches only its own arguments and a private file handle.
static bool parse_records(const char* path, int max_alleles, int n_samples,
                          int64_t start_off, int64_t end_off,
                          std::vector<std::string>& chroms, KVcfImpl* impl) {
    gzFile f = gzopen(path, "rb");
    if (!f) return false;
    gzbuffer(f, 1 << 20);
    if (start_off > 0 && gzseek(f, (z_off_t)start_off, SEEK_SET) < 0) {
        gzclose(f);
        return false;
    }
    std::string line;
    ParseScratch sc;
    while (true) {
        if (end_off >= 0 && gztell(f) >= end_off) break;
        if (!read_line(f, line)) break;
        if (line.empty()) continue;
        if (line[0] == '#') continue;   // header lines precede start_off
        parse_record_line(line, max_alleles, n_samples, chroms, impl, sc);
    }
    gzclose(f);
    return true;
}

// The same over a PLAIN (non-gzip) file with real fseek — the anchored
// parallel path needs O(1) seeks per thread (gzseek on a fresh handle
// reads-and-discards the prefix even in transparent mode, which made the
// threads collectively re-read the whole file).
static bool parse_records_plain(const char* path, int max_alleles,
                                int n_samples, int64_t start_off,
                                int64_t end_off,
                                std::vector<std::string>& chroms,
                                KVcfImpl* impl,
                                DirectOut* dout = nullptr) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    if (start_off > 0 && fseek(f, (long)start_off, SEEK_SET) != 0) {
        fclose(f);
        return false;
    }
    std::string pending;      // partial line carried across fread blocks
    int64_t line_start = 0;   // byte offset of pending's first char
    std::vector<char> buf(1 << 20);
    int64_t off = start_off;  // byte offset of the next unread char in buf
    ParseScratch sc;
    bool stop = false;
    while (!stop) {
        size_t n = fread(buf.data(), 1, buf.size(), f);
        if (n == 0) break;
        const char* p = buf.data();
        const char* end = p + n;
        const char* cur = p;
        while (cur < end) {
            const char* nl = (const char*)memchr(cur, '\n', end - cur);
            if (!nl) {
                if (pending.empty()) line_start = off;
                pending.append(cur, end - cur);
                off += end - cur;
                break;
            }
            int64_t this_start = pending.empty() ? off : line_start;
            off += (nl - cur) + 1;
            if (end_off >= 0 && this_start >= end_off) {
                stop = true;
                break;
            }
            // a view into buf is safe for the strtol/strtod field parses:
            // every numeric field is followed by a delimiter, and the
            // line's own '\n' (present in buf at nl) bounds the last one
            std::string_view line;
            if (!pending.empty()) {
                pending.append(cur, nl - cur);
                line = pending;
            } else {
                line = std::string_view(cur, nl - cur);
            }
            if (!line.empty() && line.back() == '\r')
                line.remove_suffix(1);
            if (!line.empty() && line[0] != '#')
                parse_record_line(line, max_alleles, n_samples, chroms,
                                  impl, sc, dout);
            pending.clear();
            cur = nl + 1;
        }
    }
    // final line without a trailing newline
    if (!stop && !pending.empty()
            && (end_off < 0 || line_start < end_off)) {
        std::string_view line = pending;
        if (!line.empty() && line.back() == '\r') line.remove_suffix(1);
        if (!line.empty() && line[0] != '#')
            parse_record_line(line, max_alleles, n_samples, chroms, impl,
                              sc, dout);
    }
    fclose(f);
    return true;
}

static KVcf* finish(KVcfImpl* impl, int n_samples, int max_alleles) {
    KVcf& p = impl->pub;
    p.sample_blob = impl->sample_blob.data();
    p.sample_blob_len = impl->sample_blob.size();
    p.n_samples = n_samples;
    p.n_records = (int64_t)impl->pos.size();
    p.max_alleles = max_alleles;
    p.pos = impl->pos.data();
    p.qual = impl->qual.data();
    p.mq = impl->mq.data();
    p.n_alleles = impl->n_alleles.data();
    p.chrom_id = impl->chrom_id.data();
    p.chrom_blob = impl->chrom_blob.data();
    p.chrom_blob_len = impl->chrom_blob.size();
    p.allele_blob = impl->allele_blob.data();
    p.allele_blob_len = impl->allele_blob.size();
    p.allele_off = impl->allele_off.data();
    int64_t total = 0;
    for (int32_t na : impl->n_alleles) total += na;
    p.n_allele_strings = total;
    p.dp = impl->dp.data();
    p.gq = impl->gq.data();
    p.ad = impl->ad.data();
    p.rlen = impl->rlen.data();
    p.alen = impl->alen.data();
    return &p;
}

KVcf* kvcf_read_range(const char* path, int max_alleles,
                      int64_t start_off, int64_t end_off) {
    auto* impl = new KVcfImpl();
    int n_samples = 0;
    int64_t header_end = 0;
    if (!parse_header(path, impl->sample_blob, n_samples, header_end)) {
        delete impl;
        return nullptr;
    }
    std::vector<std::string> chroms;
    int64_t s = start_off > 0 ? start_off : header_end;
    if (!parse_records(path, max_alleles, n_samples, s, end_off, chroms,
                       impl)) {
        delete impl;
        return nullptr;
    }
    return finish(impl, n_samples, max_alleles);
}

// Anchored parallel parse: ``anchors`` is a sorted list of n_spans + 1
// record-line byte offsets (from the byte-offset index); span i =
// [anchors[i], anchors[i+1]) is parsed by its own thread over the plain
// (already decompressed) file, and the spans concatenate in order —
// output arrays are element-identical to the single-thread parse.
KVcf* kvcf_read_anchored(const char* path, int max_alleles,
                         const int64_t* anchors, const int64_t* row_starts,
                         int n_spans) {
    if (n_spans < 1) return nullptr;
    {   // plain files only: per-thread gzseek would re-inflate the prefix
        FILE* probe = fopen(path, "rb");
        if (!probe) return nullptr;
        unsigned char magic[2] = {0, 0};
        size_t got = fread(magic, 1, 2, probe);
        fclose(probe);
        if (got == 2 && magic[0] == 0x1f && magic[1] == 0x8b)
            return nullptr;
    }
    auto* out = new KVcfImpl();
    int n_samples = 0;
    int64_t header_end = 0;
    if (!parse_header(path, out->sample_blob, n_samples, header_end)) {
        delete out;
        return nullptr;
    }

    // the bulk (rows x samples[ x alleles]) arrays are preallocated once
    // from the caller's per-span row counts (the byte-offset index knows
    // them); each thread writes its own row range in place, so the merge
    // below only touches the small per-record arrays
    int64_t total_rows = row_starts[n_spans];
    out->dp.resize((size_t)total_rows * n_samples);
    out->gq.resize((size_t)total_rows * n_samples);
    out->ad.resize((size_t)total_rows * n_samples * max_alleles);

    std::vector<KVcfImpl> parts(n_spans);
    std::vector<std::vector<std::string>> part_chroms(n_spans);
    std::vector<char> ok(n_spans, 0);
    {
        std::vector<std::thread> threads;
        for (int i = 0; i < n_spans; ++i)
            threads.emplace_back([&, i] {
                DirectOut dout{out->dp.data(), out->gq.data(),
                               out->ad.data(), row_starts[i]};
                ok[i] = parse_records_plain(path, max_alleles, n_samples,
                                            anchors[i], anchors[i + 1],
                                            part_chroms[i], &parts[i],
                                            &dout)
                        && dout.row == row_starts[i + 1];
            });
        for (auto& t : threads) t.join();
    }
    for (int i = 0; i < n_spans; ++i)
        if (!ok[i]) { delete out; return nullptr; }

    // merge in span order: global chrom interning (first-seen), allele
    // offsets rebased by the running allele-string count.  Exact reserves
    // first — growth-by-doubling on the GB-scale vectors (the AD cube)
    // would otherwise copy the data log(n) extra times
    {
        size_t nrec = 0, nad = 0, nblob = 0;
        for (auto& p : parts) {
            nrec += p.pos.size();
            nad += p.ad.size();
            nblob += p.allele_blob.size();
        }
        out->pos.reserve(nrec);
        out->qual.reserve(nrec);
        out->mq.reserve(nrec);
        out->n_alleles.reserve(nrec);
        out->chrom_id.reserve(nrec);
        out->rlen.reserve(nrec);
        out->allele_off.reserve(nrec);
        out->alen.reserve(nrec * (size_t)max_alleles);
        out->allele_blob.reserve(nblob);
        (void)nad;
    }
    std::vector<std::string> gchroms;
    int64_t allele_base = 0;
    for (int i = 0; i < n_spans; ++i) {
        KVcfImpl& p = parts[i];
        std::vector<int32_t> remap(part_chroms[i].size());
        for (size_t c = 0; c < part_chroms[i].size(); ++c) {
            int32_t gid = -1;
            for (size_t g = 0; g < gchroms.size(); ++g)
                if (gchroms[g] == part_chroms[i][c]) {
                    gid = (int32_t)g;
                    break;
                }
            if (gid < 0) {
                gid = (int32_t)gchroms.size();
                gchroms.push_back(part_chroms[i][c]);
                out->chrom_blob += part_chroms[i][c];
                out->chrom_blob += '\0';
            }
            remap[c] = gid;
        }
        for (int32_t cid : p.chrom_id)
            out->chrom_id.push_back(remap[cid]);
        for (int64_t off : p.allele_off)
            out->allele_off.push_back(off + allele_base);
        for (int32_t na : p.n_alleles) allele_base += na;

        auto cat = [](auto& dst, auto& src) {
            dst.insert(dst.end(), src.begin(), src.end());
        };
        cat(out->pos, p.pos);
        cat(out->qual, p.qual);
        cat(out->mq, p.mq);
        cat(out->n_alleles, p.n_alleles);
        cat(out->rlen, p.rlen);
        cat(out->alen, p.alen);
        out->allele_blob += p.allele_blob;
    }
    return finish(out, n_samples, max_alleles);
}

KVcf* kvcf_read(const char* path, int max_alleles) {
    return kvcf_read_range(path, max_alleles, 0, -1);
}

void kvcf_free(KVcf* v) {
    if (!v) return;
    delete reinterpret_cast<KVcfImpl*>(v);
}

// One-pass byte-offset index (replaces the VcfOffsetIndex Python scan,
// krisp_tpu/vcf/parser.py): inflate (or read plain), optionally write the
// decompressed copy to out_plain, and record per-record (chrom_id, POS,
// line byte offset, REF length) plus the global allele-count maximum.
// Offsets are into the decompressed stream = out_plain's bytes.

struct KIdx {
    char* sample_blob;        // #CHROM columns 10+, NUL separated
    size_t sample_blob_len;
    char* chrom_blob;         // distinct contigs, first-seen order
    size_t chrom_blob_len;
    int64_t n_records;
    int32_t max_alleles;
    int64_t file_end;         // decompressed byte length
    int32_t* chrom_id;        // [n_records]
    int64_t* pos;             // [n_records] 1-based POS
    int64_t* off;             // [n_records] line start byte offset
    int32_t* rlen;            // [n_records] REF length
};

struct KIdxImpl {
    KIdx pub;
    std::string sample_blob, chrom_blob;
    std::vector<int32_t> chrom_id, rlen;
    std::vector<int64_t> pos, off;
};

void kvcf_index_free(KIdx* p) {
    if (!p) return;
    delete reinterpret_cast<KIdxImpl*>(p);
}

KIdx* kvcf_index(const char* path, const char* out_plain) {
    gzFile f = gzopen(path, "rb");
    if (!f) return nullptr;
    gzbuffer(f, 1 << 20);
    FILE* out = nullptr;
    if (out_plain && out_plain[0]) {
        out = fopen(out_plain, "wb");
        if (!out) { gzclose(f); return nullptr; }
    }

    auto* impl = new KIdxImpl();
    std::vector<std::string> chroms;
    int32_t max_alleles = 0;
    bool bad = false;

    auto process = [&](const char* lp, size_t ln, int64_t loff) {
        if (ln == 0) return;
        if (lp[0] == '#') {
            if (ln >= 6 && memcmp(lp, "#CHROM", 6) == 0) {
                std::string_view l(lp, ln);
                if (!l.empty() && l.back() == '\r') l.remove_suffix(1);
                size_t start = 0;
                int fi = 0;
                while (true) {
                    size_t t = l.find('\t', start);
                    std::string_view tok =
                        t == std::string_view::npos
                            ? l.substr(start) : l.substr(start, t - start);
                    if (fi >= 9) {
                        impl->sample_blob += tok;
                        impl->sample_blob += '\0';
                    }
                    if (t == std::string_view::npos) break;
                    start = t + 1;
                    ++fi;
                }
            }
            return;
        }
        bool blank = true;
        for (size_t i = 0; i < ln; ++i)
            if (lp[i] != ' ' && lp[i] != '\t' && lp[i] != '\r') {
                blank = false;
                break;
            }
        if (blank) return;
        std::string_view l(lp, ln);
        size_t t1 = l.find('\t');
        size_t t2 = t1 == std::string_view::npos ? t1 : l.find('\t', t1 + 1);
        size_t t3 = t2 == std::string_view::npos ? t2 : l.find('\t', t2 + 1);
        size_t t4 = t3 == std::string_view::npos ? t3 : l.find('\t', t3 + 1);
        size_t t5 = t4 == std::string_view::npos ? t4 : l.find('\t', t4 + 1);
        if (t5 == std::string_view::npos) { bad = true; return; }
        std::string_view chrom = l.substr(0, t1);
        std::string_view ref = l.substr(t3 + 1, t4 - t3 - 1);
        std::string_view alt = l.substr(t4 + 1, t5 - t4 - 1);
        int32_t cid = -1;
        for (size_t i = 0; i < chroms.size(); ++i)
            if (chroms[i] == chrom) { cid = (int32_t)i; break; }
        if (cid < 0) {
            cid = (int32_t)chroms.size();
            chroms.emplace_back(chrom);
            impl->chrom_blob += chrom;
            impl->chrom_blob += '\0';
        }
        impl->chrom_id.push_back(cid);
        // POS is tab-delimited, so strtoll stops without a NUL copy; a
        // malformed field rejects the whole parse (the Python fallback
        // raises ValueError on the same input — never silent zeros)
        char* pos_end = nullptr;
        long long pv = strtoll(lp + t1 + 1, &pos_end, 10);
        if (pos_end != lp + t2) { bad = true; return; }
        impl->pos.push_back(pv);
        impl->off.push_back(loff);
        impl->rlen.push_back((int32_t)ref.size());
        int32_t na = 1;
        if (!alt.empty() && alt != ".") {
            na = 2;
            for (char c : alt)
                if (c == ',') ++na;
        }
        if (na > max_alleles) max_alleles = na;
    };

    std::vector<char> buf(1 << 20);
    std::string pending;
    int64_t pending_off = 0;
    int64_t global = 0;
    while (!bad) {
        int n = gzread(f, buf.data(), (unsigned)buf.size());
        if (n < 0) bad = true;
        if (n <= 0) break;
        if (out && fwrite(buf.data(), 1, (size_t)n, out) != (size_t)n) {
            bad = true;
            break;
        }
        const char* p = buf.data();
        const char* end = p + n;
        const char* cur = p;
        while (cur < end && !bad) {
            const char* nl = (const char*)memchr(cur, '\n', end - cur);
            if (!nl) {
                if (pending.empty()) pending_off = global + (cur - p);
                pending.append(cur, end - cur);
                break;
            }
            if (!pending.empty()) {
                pending.append(cur, nl - cur);
                process(pending.data(), pending.size(), pending_off);
                pending.clear();
            } else {
                process(cur, (size_t)(nl - cur), global + (cur - p));
            }
            cur = nl + 1;
        }
        global += n;
    }
    if (!bad && !pending.empty())
        process(pending.data(), pending.size(), pending_off);
    gzclose(f);
    if (out) fclose(out);
    if (bad) { delete impl; return nullptr; }

    KIdx& p = impl->pub;
    p.sample_blob = impl->sample_blob.data();
    p.sample_blob_len = impl->sample_blob.size();
    p.chrom_blob = impl->chrom_blob.data();
    p.chrom_blob_len = impl->chrom_blob.size();
    p.n_records = (int64_t)impl->pos.size();
    p.max_alleles = max_alleles;
    p.file_end = global;
    p.chrom_id = impl->chrom_id.data();
    p.pos = impl->pos.data();
    p.off = impl->off.data();
    p.rlen = impl->rlen.data();
    return &p;
}

// Sliding-window replay for the scan prefilter — the exact two-pointer /
// monotonic-deque algorithm of krisp_tpu/vcf/fastscan.py:_window_types
// (which stays as the Python oracle; equality is fuzz-pinned by
// tests/test_native_vcf.py).  Types every (end) window of the group's
// sliding deque: 0 empty, 1 Undiagnostic, 2 Unconserved, 3 Misplaced,
// 4 candidate.  Reference deque semantics: krisp_vcf.py:171-218.
void kvcf_window_types(const int64_t* starts, const int64_t* ends,
                       const int64_t* delta, const uint8_t* is_diag,
                       const uint8_t* is_consv, int64_t V, int64_t span,
                       int64_t min_vars, int8_t* types, int64_t* jstart) {
    std::vector<int64_t> dpre(V + 1, 0), dsum(V + 1, 0), usum(V + 1, 0);
    for (int64_t i = 0; i < V; ++i) {
        dpre[i + 1] = dpre[i] + delta[i];
        dsum[i + 1] = dsum[i] + (is_diag[i] ? 1 : 0);
        usum[i + 1] = usum[i] + (is_consv[i] ? 0 : 1);
    }
    // monotonic index deques as ring-less arrays (each e enters once)
    std::vector<int64_t> maxdq(V), mindq(V);
    int64_t mx0 = 0, mx1 = 0, mn0 = 0, mn1 = 0, j = 0;
    for (int64_t e = 0; e < V; ++e) {
        const int64_t ee = ends[e];
        while (mx1 > mx0 && ends[maxdq[mx1 - 1]] <= ee) --mx1;
        maxdq[mx1++] = e;
        const int64_t se = starts[e];
        while (mn1 > mn0 && starts[mindq[mn1 - 1]] >= se) --mn1;
        mindq[mn1++] = e;
        while (j <= e) {
            const int64_t length = ends[maxdq[mx0]] - starts[mindq[mn0]]
                                   + 1 + dpre[e + 1] - dpre[j];
            if (length <= span) break;
            ++j;
            if (maxdq[mx0] < j) ++mx0;
            if (mindq[mn0] < j) ++mn0;
        }
        jstart[e] = j;
        if (j > e) { types[e] = 0; continue; }
        const int64_t nd = dsum[e + 1] - dsum[j];
        if (nd < min_vars) types[e] = 1;
        else if (usum[e + 1] - usum[j] > 0) types[e] = 2;
        else if (nd == 1 && !is_diag[e]) types[e] = 3;
        else types[e] = 4;
    }
}

}  // extern "C"
