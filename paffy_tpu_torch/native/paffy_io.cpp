// Native host ingest/egress for paffy_tpu_torch: PAF tokenizer and
// serializer.  A copy of paffy_tpu/native/paffy_io.cpp, so that the port
// owns its host layer; tests/test_torch_host.py holds the two libraries'
// outputs equal.  paffy_tpu_torch/native/__init__.py builds it with g++
// into paffy_tpu_torch/_build/ and binds the entry points the port calls.
//
// The reference's parser is a hand-rolled byte scanner precisely because
// ingest is the hot host path (impl/paf.c:10-48,137-209); this module plays
// that role, producing the columnar SoA/CSR arrays that ship straight to
// the device, and serializing them back byte-identically (tag rules of
// impl/paf.c:317-389).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency):
//   two-pass protocol — pass 1 counts records/ops/name bytes, caller
//   allocates numpy arrays, pass 2 fills them.

#include <algorithm>
#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <functional>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// strtok-style field tokenizer: consecutive tabs collapse and leading
// tabs are skipped (the reference splits with strtok, impl/paf.c:139-209),
// so an empty field SHIFTS the remaining tokens left rather than parsing
// as an empty value.  Fills up to ``want`` token [start, end) pairs;
// returns the token count.
static inline int tokenize_fields(const char* p, const char* le,
                                  const char** f, const char** fe,
                                  int want) {
    int nf = 0;
    const char* s = p;
    while (s < le && *s == '\t') ++s;
    while (nf < want && s < le) {
        f[nf] = s;
        const char* t = (const char*)memchr(s, '\t', le - s);
        fe[nf] = t ? t : le;
        ++nf;
        if (!t) break;
        s = t + 1;
        while (s < le && *s == '\t') ++s;
    }
    return nf;
}

// ---------------------------------------------------------------- pass 1
// Count lines, cigar ops and name bytes over [p, end). Returns 0 on
// success, else the (1-based, range-local) line number of the first
// malformed line.  n_lines counts every line in the range (for global
// line numbering by the threaded entry).
static long long scan_range(const char* p, const char* end,
                            long long* n_records, long long* n_ops,
                            long long* name_bytes, long long* n_lines) {
    long long recs = 0, ops = 0, names = 0;
    long long line_no = 0;
    while (p < end) {
        const char* eol = (const char*)memchr(p, '\n', end - p);
        const char* le = eol ? eol : end;
        ++line_no;
        if (le == p) return line_no;  // blank line: the reference
        // segfaults here (strtok NULL, impl/paf.c:139) — reject
        const char* f[12];
        const char* fe[12];
        if (tokenize_fields(p, le, f, fe, 12) < 12) return line_no;
        names += fe[0] - f[0] + 1;
        names += fe[5] - f[5] + 1;
        // find a cg:Z: tag and count its ops (tags start after token 11,
        // exactly where the fill pass looks)
        const char* s = fe[11];
        while (s && s < le) {
            const char* tag = (const char*)memchr(s, '\t', le - s);
            if (!tag) break;
            ++tag;
            if (le - tag >= 5 && tag[0] == 'c' && tag[1] == 'g' &&
                tag[2] == ':' && tag[4] == ':') {
                const char* c = tag + 5;
                const char* ce = (const char*)memchr(c, '\t', le - c);
                if (!ce) ce = le;
                for (const char* x = c; x < ce; ++x) {
                    char ch = *x;
                    if (ch == 'M' || ch == 'I' || ch == 'D' || ch == '=' ||
                        ch == 'X') ++ops;
                    else if (ch < '0' || ch > '9') return line_no;
                }
                break;
            }
            s = tag;
        }
        ++recs;
        p = le + 1;
    }
    *n_records = recs;
    *n_ops = ops;
    *name_bytes = names;
    *n_lines = line_no;
    return 0;
}

long long paf_scan(const char* buf, long long len,
                   long long* n_records, long long* n_ops,
                   long long* name_bytes) {
    long long lines;
    return scan_range(buf, buf + len, n_records, n_ops, name_bytes, &lines);
}

// Newline-aligned shard boundaries for the threaded passes.
static void shard_bounds(const char* buf, long long len, long long T,
                         long long* b) {
    b[0] = 0;
    b[T] = len;
    for (long long s = 1; s < T; ++s) {
        long long pos = len * s / T;
        if (pos < b[s - 1]) pos = b[s - 1];
        const char* nl = (const char*)memchr(buf + pos, '\n', len - pos);
        b[s] = nl ? (nl - buf) + 1 : len;
        if (b[s] < b[s - 1]) b[s] = b[s - 1];
    }
}

// Threaded pass 1: per-shard record/op/name-byte/line counts at newline-
// aligned boundaries (caller cumsums them into pass-2 bases).  Returns 0
// or the GLOBAL 1-based line number of the first malformed line.
long long paf_scan_mt(const char* buf, long long len, long long n_threads,
                      long long* bounds,       // [T+1], filled here
                      long long* recs, long long* ops, long long* names,
                      long long* lines) {      // [T] each
    const long long T = n_threads;
    shard_bounds(buf, len, T, bounds);
    std::vector<long long> bad(T, 0);
    auto work = [&](long long s) {
        bad[s] = scan_range(buf + bounds[s], buf + bounds[s + 1],
                            recs + s, ops + s, names + s, lines + s);
    };
    if (T == 1) {
        work(0);
    } else {
        std::vector<std::thread> th;
        for (long long s = 0; s < T; ++s) th.emplace_back(work, s);
        for (auto& t : th) t.join();
    }
    long long line_base = 0;
    for (long long s = 0; s < T; ++s) {
        if (bad[s]) return line_base + bad[s];
        line_base += lines[s];
    }
    return 0;
}

// Raw-cigar scan: count records and name bytes only — the cg tag is kept
// as an unparsed byte range (the reference's read_pafs(parse_cigar=0)
// mode, impl/paf_chain.c:128 / impl/paf_tile.c:156: commands that never
// touch per-op data skip the digit parse entirely and re-emit the string
// verbatim).
static long long scan_raw_range(const char* p, const char* end,
                                long long* n_records, long long* name_bytes,
                                long long* n_lines) {
    long long recs = 0, names = 0;
    long long line_no = 0;
    while (p < end) {
        const char* eol = (const char*)memchr(p, '\n', end - p);
        const char* le = eol ? eol : end;
        ++line_no;
        if (le == p) return line_no;  // blank line (see scan_range)
        const char* f[12];
        const char* fe[12];
        if (tokenize_fields(p, le, f, fe, 12) < 12) return line_no;
        names += fe[0] - f[0] + 1;
        names += fe[5] - f[5] + 1;
        ++recs;
        p = le + 1;
    }
    *n_records = recs;
    *name_bytes = names;
    *n_lines = line_no;
    return 0;
}

long long paf_scan_raw(const char* buf, long long len,
                       long long* n_records, long long* name_bytes) {
    long long lines = 0;
    return scan_raw_range(buf, buf + len, n_records, name_bytes, &lines);
}

// Threaded raw scan over newline-aligned shard bounds (mirrors
// paf_scan_mt): per-shard record/name counts for the fill pass's base
// offsets.  Returns 0 or the GLOBAL 1-based first bad line.
long long paf_scan_raw_mt(const char* buf, long long len,
                          long long n_threads,
                          long long* bounds,            // [T+1] out
                          long long* rec_cnt,           // [T] out
                          long long* name_cnt,          // [T] out
                          long long* lines) {           // [T] out
    const long long T = n_threads;
    shard_bounds(buf, len, T, bounds);
    std::vector<long long> bad(T, 0);
    auto work = [&](long long s) {
        bad[s] = scan_raw_range(buf + bounds[s], buf + bounds[s + 1],
                                &rec_cnt[s], &name_cnt[s], &lines[s]);
    };
    if (T == 1) {
        work(0);
    } else {
        std::vector<std::thread> th;
        for (long long s = 0; s < T; ++s) th.emplace_back(work, s);
        for (auto& t : th) t.join();
    }
    long long line_base = 0;
    for (long long s = 0; s < T; ++s) {
        if (bad[s]) return line_base + bad[s];
        line_base += lines[s];
    }
    return 0;
}

static inline long long parse_i64(const char* s, const char* e) {
    long long v = 0;
    bool neg = false;
    if (s < e && *s == '-') { neg = true; ++s; }
    while (s < e && *s >= '0' && *s <= '9') v = v * 10 + (*s++ - '0');
    return neg ? -v : v;
}

// ---------------------------------------------------------------- pass 2
// Fill the SoA arrays. ints layout (per record, int64):
//   qlen qstart qend tlen tstart tend nmatch nbases mapq score tile chain cs
// flags: bit0 strand('+'), bit1 has_cigar; type: uint8.
// qname_off/tname_off index into the name_pool (NUL-terminated strings).
// Returns 0 on success or the (range-local) 1-based line number of the
// first bad line.  rec/op/npos are this range's global base offsets (0 for
// the single-thread entry); cig_off[0] is the caller's responsibility.
static long long fill_range(const char* p, const char* end,
                            long long rec, long long op, long long npos,
                            long long* ints, unsigned char* flags,
                            unsigned char* type,
                            long long* qname_off, long long* tname_off,
                            char* name_pool,
                            unsigned char* ops, long long* op_lens,
                            long long* cig_off) {
    long long line_no = 0;
    while (p < end) {
        const char* eol = (const char*)memchr(p, '\n', end - p);
        const char* le = eol ? eol : end;
        ++line_no;
        if (le == p) return line_no;  // blank line (see scan_range)
        const char* f[12];
        const char* fe[12];
        if (tokenize_fields(p, le, f, fe, 12) < 12) return line_no;

        long long* R = ints + rec * 13;
        // names
        qname_off[rec] = npos;
        memcpy(name_pool + npos, f[0], fe[0] - f[0]);
        npos += fe[0] - f[0];
        name_pool[npos++] = '\0';
        tname_off[rec] = npos;
        memcpy(name_pool + npos, f[5], fe[5] - f[5]);
        npos += fe[5] - f[5];
        name_pool[npos++] = '\0';
        // mandatory ints
        R[0] = parse_i64(f[1], fe[1]);
        R[1] = parse_i64(f[2], fe[2]);
        R[2] = parse_i64(f[3], fe[3]);
        char strand = *f[4];
        if (strand != '+' && strand != '-') return line_no;
        R[3] = parse_i64(f[6], fe[6]);
        R[4] = parse_i64(f[7], fe[7]);
        R[5] = parse_i64(f[8], fe[8]);
        R[6] = parse_i64(f[9], fe[9]);
        R[7] = parse_i64(f[10], fe[10]);
        R[8] = parse_i64(f[11], fe[11]);
        // defaults (impl/paf.c:138,175-177)
        R[9] = 0; R[10] = -1; R[11] = -1; R[12] = -1;
        unsigned char fl = (strand == '+') ? 1 : 0;
        type[rec] = 0;
        // tags
        const char* tg = fe[11];
        while (tg < le && *tg == '\t') {
            ++tg;
            const char* te = (const char*)memchr(tg, '\t', le - tg);
            if (!te) te = le;
            if (te - tg >= 5 && tg[2] == ':' && tg[4] == ':') {
                const char* v = tg + 5;
                if (tg[0] == 't' && tg[1] == 'p') {
                    char c = *v;
                    if (c != 'P' && c != 'S' && c != 'I') return line_no;
                    type[rec] = (unsigned char)c;
                } else if (tg[0] == 'A' && tg[1] == 'S') {
                    R[9] = parse_i64(v, te);
                } else if (tg[0] == 't' && tg[1] == 'l') {
                    R[10] = parse_i64(v, te);
                } else if (tg[0] == 'c' && tg[1] == 'n') {
                    R[11] = parse_i64(v, te);
                } else if (tg[0] == 's' && tg[1] == '1') {
                    R[12] = parse_i64(v, te);
                } else if (tg[0] == 'c' && tg[1] == 'g') {
                    long long op0 = op;
                    long long ln = 0;
                    for (const char* x = v; x < te; ++x) {
                        char ch = *x;
                        if (ch >= '0' && ch <= '9') {
                            ln = ln * 10 + (ch - '0');
                        } else {
                            unsigned char code;
                            switch (ch) {
                                case 'M': code = 0; break;
                                case 'I': code = 1; break;
                                case 'D': code = 2; break;
                                case '=': code = 3; break;
                                case 'X': code = 4; break;
                                default: return line_no;
                            }
                            ops[op] = code;
                            op_lens[op] = ln;
                            ++op;
                            ln = 0;
                        }
                    }
                    if (op > op0) fl |= 2;
                }
            }
            tg = te;
        }
        flags[rec] = fl;
        cig_off[rec + 1] = op;
        ++rec;
        p = le + 1;
    }
    return 0;
}

long long paf_fill(const char* buf, long long len,
                   long long* ints, unsigned char* flags,
                   unsigned char* type,
                   long long* qname_off, long long* tname_off,
                   char* name_pool,
                   unsigned char* ops, long long* op_lens,
                   long long* cig_off) {
    cig_off[0] = 0;
    return fill_range(buf, buf + len, 0, 0, 0, ints, flags, type,
                      qname_off, tname_off, name_pool, ops, op_lens,
                      cig_off);
}

// Threaded pass 2 over paf_scan_mt's shard bounds; rec/op/name bases are
// the exclusive prefix sums of the per-shard scan counts.  Returns 0 or
// the GLOBAL 1-based line number of the first bad line.
long long paf_fill_mt(const char* buf, long long len, long long n_threads,
                      const long long* bounds,                 // [T+1]
                      const long long* rec_base,               // [T]
                      const long long* op_base,                // [T]
                      const long long* name_base,              // [T]
                      const long long* lines,                  // [T]
                      long long* ints, unsigned char* flags,
                      unsigned char* type,
                      long long* qname_off, long long* tname_off,
                      char* name_pool,
                      unsigned char* ops, long long* op_lens,
                      long long* cig_off) {
    const long long T = n_threads;
    cig_off[0] = 0;
    std::vector<long long> bad(T, 0);
    auto work = [&](long long s) {
        bad[s] = fill_range(buf + bounds[s], buf + bounds[s + 1],
                            rec_base[s], op_base[s], name_base[s],
                            ints, flags, type, qname_off, tname_off,
                            name_pool, ops, op_lens, cig_off);
    };
    if (T == 1) {
        work(0);
    } else {
        std::vector<std::thread> th;
        for (long long s = 0; s < T; ++s) th.emplace_back(work, s);
        for (auto& t : th) t.join();
    }
    long long line_base = 0;
    for (long long s = 0; s < T; ++s) {
        if (bad[s]) return line_base + bad[s];
        line_base += lines[s];
    }
    return 0;
}

// Raw-cigar fill: identical field/tag walk to paf_fill, but the cg tag is
// recorded as an unparsed [cg_start, cg_start+cg_len) byte range into the
// input buffer instead of op arrays (paf_scan_raw's pass 2).
// validate != 0: cigar TEXT is checked against the reference parser's
// acceptance rule (runs of digits + one of MIDX=; anything else is the
// cigar_parse abort, impl/paf.c:102) and *noncanon is set when any length
// has a leading zero — valid input the full parser would CANONICALIZE on
// re-emit, so verbatim raw re-emission would diverge; callers fall back
// to the full parse for those (rare) inputs.
static long long fill_raw_range(const char* buf,       // cg offsets base
                                const char* p, const char* end,
                                long long rec, long long npos,
                                long long* ints,
                                unsigned char* flags, unsigned char* type,
                                long long* qname_off, long long* tname_off,
                                char* name_pool,
                                long long* cg_start, long long* cg_len,
                                long long validate, long long* noncanon) {
    long long line_no = 0;
    while (p < end) {
        const char* eol = (const char*)memchr(p, '\n', end - p);
        const char* le = eol ? eol : end;
        ++line_no;
        if (le == p) return line_no;  // blank line (see scan_range)
        const char* f[12];
        const char* fe[12];
        if (tokenize_fields(p, le, f, fe, 12) < 12) return line_no;
        long long* R = ints + rec * 13;
        qname_off[rec] = npos;
        memcpy(name_pool + npos, f[0], fe[0] - f[0]);
        npos += fe[0] - f[0];
        name_pool[npos++] = '\0';
        tname_off[rec] = npos;
        memcpy(name_pool + npos, f[5], fe[5] - f[5]);
        npos += fe[5] - f[5];
        name_pool[npos++] = '\0';
        R[0] = parse_i64(f[1], fe[1]);
        R[1] = parse_i64(f[2], fe[2]);
        R[2] = parse_i64(f[3], fe[3]);
        char strand = *f[4];
        if (strand != '+' && strand != '-') return line_no;
        R[3] = parse_i64(f[6], fe[6]);
        R[4] = parse_i64(f[7], fe[7]);
        R[5] = parse_i64(f[8], fe[8]);
        R[6] = parse_i64(f[9], fe[9]);
        R[7] = parse_i64(f[10], fe[10]);
        R[8] = parse_i64(f[11], fe[11]);
        R[9] = 0; R[10] = -1; R[11] = -1; R[12] = -1;
        unsigned char fl = (strand == '+') ? 1 : 0;
        type[rec] = 0;
        cg_start[rec] = 0;
        cg_len[rec] = 0;
        const char* tg = fe[11];
        while (tg < le && *tg == '\t') {
            ++tg;
            const char* te = (const char*)memchr(tg, '\t', le - tg);
            if (!te) te = le;
            if (te - tg >= 5 && tg[2] == ':' && tg[4] == ':') {
                const char* v = tg + 5;
                if (tg[0] == 't' && tg[1] == 'p') {
                    char c = *v;
                    if (c != 'P' && c != 'S' && c != 'I') return line_no;
                    type[rec] = (unsigned char)c;
                } else if (tg[0] == 'A' && tg[1] == 'S') {
                    R[9] = parse_i64(v, te);
                } else if (tg[0] == 't' && tg[1] == 'l') {
                    R[10] = parse_i64(v, te);
                } else if (tg[0] == 'c' && tg[1] == 'n') {
                    R[11] = parse_i64(v, te);
                } else if (tg[0] == 's' && tg[1] == '1') {
                    R[12] = parse_i64(v, te);
                } else if (tg[0] == 'c' && tg[1] == 'g') {
                    if (te > v) {
                        if (validate) {
                            const char* c = v;
                            while (c < te) {
                                if (*c < '0' || *c > '9') return line_no;
                                if (*c == '0' && c + 1 < te
                                    && c[1] >= '0' && c[1] <= '9')
                                    *noncanon = 1;
                                while (c < te && *c >= '0' && *c <= '9')
                                    ++c;
                                if (c >= te) return line_no;
                                const char op = *c++;
                                if (op != 'M' && op != 'I' && op != 'D'
                                    && op != 'X' && op != '=')
                                    return line_no;
                            }
                        }
                        cg_start[rec] = v - buf;
                        cg_len[rec] = te - v;
                        fl |= 2;
                    }
                }
            }
            tg = te;
        }
        flags[rec] = fl;
        ++rec;
        p = le + 1;
    }
    return 0;
}

long long paf_fill_raw(const char* buf, long long len,
                       long long* ints,
                       unsigned char* flags, unsigned char* type,
                       long long* qname_off, long long* tname_off,
                       char* name_pool,
                       long long* cg_start, long long* cg_len,
                       long long validate, long long* noncanon) {
    return fill_raw_range(buf, buf, buf + len, 0, 0, ints, flags, type,
                          qname_off, tname_off, name_pool, cg_start, cg_len,
                          validate, noncanon);
}

// Threaded raw fill over paf_scan_raw_mt's shard bounds; rec/name bases
// are the exclusive prefix sums of the per-shard scan counts.  Returns 0
// or the GLOBAL 1-based first bad line.
long long paf_fill_raw_mt(const char* buf, long long len,
                          long long n_threads,
                          const long long* bounds,       // [T+1]
                          const long long* rec_base,     // [T]
                          const long long* name_base,    // [T]
                          const long long* lines,        // [T]
                          long long* ints,
                          unsigned char* flags, unsigned char* type,
                          long long* qname_off, long long* tname_off,
                          char* name_pool,
                          long long* cg_start, long long* cg_len,
                          long long validate, long long* noncanon) {
    (void)len;
    const long long T = n_threads;
    std::vector<long long> bad(T, 0), nc(T, 0);
    auto work = [&](long long s) {
        bad[s] = fill_raw_range(buf, buf + bounds[s], buf + bounds[s + 1],
                                rec_base[s], name_base[s], ints, flags,
                                type, qname_off, tname_off, name_pool,
                                cg_start, cg_len, validate, &nc[s]);
    };
    if (T == 1) {
        work(0);
    } else {
        std::vector<std::thread> th;
        for (long long s = 0; s < T; ++s) th.emplace_back(work, s);
        for (auto& t : th) t.join();
    }
    for (long long s = 0; s < T; ++s)
        if (nc[s]) *noncanon = 1;
    long long line_base = 0;
    for (long long s = 0; s < T; ++s) {
        if (bad[s]) return line_base + bad[s];
        line_base += lines[s];
    }
    return 0;
}

// ---------------------------------------------------------- serialization

// Two-digit pair table: one divide per two digits (the serializer and the
// fused mismatch encoder write tens of millions of small integers; the
// per-digit %10 loop measured as a main cost of the encode fill pass).
static const char DIGIT2[201] =
    "00010203040506070809101112131415161718192021222324"
    "25262728293031323334353637383940414243444546474849"
    "50515253545556575859606162636465666768697071727374"
    "75767778798081828384858687888990919293949596979899";

static inline char* write_i64(char* b, long long v) {
    unsigned long long u;
    if (v < 0) { *b++ = '-'; u = (unsigned long long)(-v); }
    else u = (unsigned long long)v;
    char tmp[24];
    char* p = tmp + 24;
    while (u >= 100) {
        const unsigned r = (unsigned)(u % 100);
        u /= 100;
        p -= 2;
        memcpy(p, DIGIT2 + 2 * r, 2);
    }
    if (u < 10) {
        *--p = (char)('0' + u);
    } else {
        p -= 2;
        memcpy(p, DIGIT2 + 2 * u, 2);
    }
    const size_t n = (size_t)(tmp + 24 - p);
    memcpy(b, p, n);
    return b + n;
}

// ---- threaded exact-size serializer ------------------------------------
// Two phases: paf_serialize_sizes measures every record's exact byte
// length (threaded), the caller prefix-sums them, and paf_serialize_fill
// writes each record at its exact offset (threaded, no compaction pass
// and no oversized bound allocation).

static inline long long i64_digits(long long v) {
    long long d = 0;
    unsigned long long u;
    if (v < 0) { d = 1; u = (unsigned long long)(-v); }
    else u = (unsigned long long)v;
    while (u >= 10000ULL) { u /= 10000ULL; d += 4; }
    return d + (u < 10ULL ? 1 : u < 100ULL ? 2 : u < 1000ULL ? 3 : 4);
}

// Byte length of everything before the cg tag (fields + tags + newline).
static long long record_prefix_len(long long i, const long long* ints,
                                   const unsigned char* flags,
                                   const unsigned char* type,
                                   const long long* qname_off,
                                   const long long* tname_off,
                                   const char* name_pool) {
    const long long* R = ints + i * 13;
    long long n = (long long)strlen(name_pool + qname_off[i])
                + (long long)strlen(name_pool + tname_off[i])
                + 11 + 2;  // 11 tabs + strand char + newline
    for (int j = 0; j < 9; ++j) n += i64_digits(R[j]);
    if (type[i] != 0 || R[10] != -1) n += 7;
    if (R[9] != 2147483647LL) n += 6 + i64_digits(R[9]);
    if (R[10] != -1) n += 6 + i64_digits(R[10]);
    if (R[11] != -1) n += 6 + i64_digits(R[11]);
    if (R[12] != -1) n += 6 + i64_digits(R[12]);
    return n;
}

static long long record_ser_len(long long i, const long long* ints,
                                const unsigned char* flags,
                                const unsigned char* type,
                                const long long* qname_off,
                                const long long* tname_off,
                                const char* name_pool,
                                const unsigned char* ops,
                                const long long* op_lens,
                                const long long* cig_off,
                                const long long* cg_len) {
    long long n = record_prefix_len(i, ints, flags, type, qname_off,
                                    tname_off, name_pool);
    if (flags[i] & 2) {
        n += 6;
        if (cg_len)  // raw-cigar mode: verbatim bytes
            n += cg_len[i];
        else
            for (long long k = cig_off[i]; k < cig_off[i + 1]; ++k)
                n += i64_digits(op_lens[k]) + 1;
    }
    return n;
}

// ``order`` (nullable) emits record order[r] at slot r — output
// reordering without ever copying the cigar arrays (the reference
// reorders an stList of pointers; chain/tile sorted output uses this).
void paf_serialize_sizes(long long n_records,
                         const long long* ints, const unsigned char* flags,
                         const unsigned char* type,
                         const long long* qname_off,
                         const long long* tname_off,
                         const char* name_pool,
                         const unsigned char* ops, const long long* op_lens,
                         const long long* cig_off, const long long* order,
                         const long long* cg_len,  // nullable: raw mode
                         long long* sizes, long long n_threads) {
    auto work = [&](long long r0, long long r1) {
        for (long long r = r0; r < r1; ++r)
            sizes[r] = record_ser_len(order ? order[r] : r, ints, flags,
                                      type, qname_off, tname_off, name_pool,
                                      ops, op_lens, cig_off, cg_len);
    };
    if (n_threads <= 1 || n_records < 4096) {
        work(0, n_records);
        return;
    }
    std::vector<std::thread> th;
    for (long long s = 0; s < n_threads; ++s)
        th.emplace_back(work, n_records * s / n_threads,
                        n_records * (s + 1) / n_threads);
    for (auto& t : th) t.join();
}

// Writes everything before the cg tag (fields + conditional tags), no
// trailing newline; returns the advanced output cursor.
static inline char* write_record_prefix(char* b, long long i,
                                        const long long* ints,
                                        const unsigned char* flags,
                                        const unsigned char* type,
                                        const long long* qname_off,
                                        const long long* tname_off,
                                        const char* name_pool) {
    const long long* R = ints + i * 13;
    const char* qn = name_pool + qname_off[i];
    size_t ql = strlen(qn);
    memcpy(b, qn, ql); b += ql;
    *b++ = '\t';
    b = write_i64(b, R[0]); *b++ = '\t';
    b = write_i64(b, R[1]); *b++ = '\t';
    b = write_i64(b, R[2]); *b++ = '\t';
    *b++ = (flags[i] & 1) ? '+' : '-'; *b++ = '\t';
    const char* tn = name_pool + tname_off[i];
    size_t tl = strlen(tn);
    memcpy(b, tn, tl); b += tl;
    *b++ = '\t';
    b = write_i64(b, R[3]); *b++ = '\t';
    b = write_i64(b, R[4]); *b++ = '\t';
    b = write_i64(b, R[5]); *b++ = '\t';
    b = write_i64(b, R[6]); *b++ = '\t';
    b = write_i64(b, R[7]); *b++ = '\t';
    b = write_i64(b, R[8]);
    if (type[i] != 0 || R[10] != -1) {
        char c = type[i] ? (char)type[i] : (R[10] > 1 ? 'S' : 'P');
        memcpy(b, "\ttp:A:", 6); b += 6;
        *b++ = c;
    }
    if (R[9] != 2147483647LL) {
        memcpy(b, "\tAS:i:", 6); b += 6;
        b = write_i64(b, R[9]);
    }
    if (R[10] != -1) {
        memcpy(b, "\ttl:i:", 6); b += 6;
        b = write_i64(b, R[10]);
    }
    if (R[11] != -1) {
        memcpy(b, "\tcn:i:", 6); b += 6;
        b = write_i64(b, R[11]);
    }
    if (R[12] != -1) {
        memcpy(b, "\ts1:i:", 6); b += 6;
        b = write_i64(b, R[12]);
    }
    return b;
}

// Returns 0 on success, 1 if any record's written length disagreed with
// its measured length (drift guard between the two passes).
long long paf_serialize_fill(long long n_records,
                             const long long* ints,
                             const unsigned char* flags,
                             const unsigned char* type,
                             const long long* qname_off,
                             const long long* tname_off,
                             const char* name_pool,
                             const unsigned char* ops,
                             const long long* op_lens,
                             const long long* cig_off, const long long* order,
                             const char* raw_buf,       // nullable: raw mode
                             const long long* cg_start,
                             const long long* cg_len,
                             const long long* out_off,  // n+1, cumsum(sizes)
                             char* out, long long n_threads) {
    static const char opch[5] = {'M', 'I', 'D', '=', 'X'};
    std::atomic<long long> bad{0};
    auto work = [&](long long r0, long long r1) {
        for (long long r = r0; r < r1; ++r) {
            const long long i = order ? order[r] : r;
            char* b = out + out_off[r];
            b = write_record_prefix(b, i, ints, flags, type, qname_off,
                                    tname_off, name_pool);
            if (flags[i] & 2) {
                memcpy(b, "\tcg:Z:", 6); b += 6;
                if (raw_buf) {
                    memcpy(b, raw_buf + cg_start[i], (size_t)cg_len[i]);
                    b += cg_len[i];
                } else {
                    for (long long k = cig_off[i]; k < cig_off[i + 1]; ++k) {
                        b = write_i64(b, op_lens[k]);
                        *b++ = opch[ops[k]];
                    }
                }
            }
            *b++ = '\n';
            if (b - (out + out_off[r]) != out_off[r + 1] - out_off[r])
                bad = 1;
        }
    };
    if (n_threads <= 1 || n_records < 4096) {
        work(0, n_records);
        return bad.load();
    }
    std::vector<std::thread> th;
    for (long long s = 0; s < n_threads; ++s)
        th.emplace_back(work, n_records * s / n_threads,
                        n_records * (s + 1) / n_threads);
    for (auto& t : th) t.join();
    return bad.load();
}

// C printf %f of a float32 value promoted to double (paf_pretty_print's
// Identity fields, impl/paf.c:272-273).  NaN keeps its sign: x86 0.0f/0.0f
// yields the default QNaN with the sign bit SET, which glibc prints as
// "-nan" — the reference binary's observable behavior on empty-match
// records (fuzz seed 11's all-D record caught the unsigned special case).
static inline char* write_f6(char* b, float v) {
    return b + snprintf(b, 40, "%f", (double)v);
}

// Batch-format the per-record `paffy view` stat lines (paf_pretty_print,
// impl/paf.c:269-281).  vals is [n,12] int64:
//   qstart qend tstart tend strand score matches mismatches
//   query_inserts query_deletes query_insert_bases query_delete_bases
// Returns bytes written; caller guarantees capacity via
// n_records * 430 + name_pool_bytes.
long long view_stats_lines(long long n_records,
                           const long long* qname_off,
                           const long long* tname_off,
                           const char* name_pool,
                           const long long* vals,
                           char* out) {
    char* b = out;
    for (long long i = 0; i < n_records; ++i) {
        const long long* V = vals + i * 12;
        const char* qn = name_pool + qname_off[i];
        const char* tn = name_pool + tname_off[i];
        size_t ql = strlen(qn), tl = strlen(tn);
        memcpy(b, "Query:", 6); b += 6;
        memcpy(b, qn, ql); b += ql;
        memcpy(b, "\tQ-start:", 9); b += 9;
        b = write_i64(b, V[0]);
        memcpy(b, "\tQ-length:", 10); b += 10;
        b = write_i64(b, V[1] - V[0]);
        memcpy(b, "\tTarget:", 8); b += 8;
        memcpy(b, tn, tl); b += tl;
        memcpy(b, "\tT-start:", 9); b += 9;
        b = write_i64(b, V[2]);
        memcpy(b, "\tT-length:", 10); b += 10;
        b = write_i64(b, V[3] - V[2]);
        memcpy(b, "\tSame-strand:", 13); b += 13;
        b = write_i64(b, V[4]);
        memcpy(b, "\tScore:", 7); b += 7;
        b = write_i64(b, V[5]);
        memcpy(b, "\tIdentity:", 10); b += 10;
        b = write_f6(b, (float)V[6] / (float)(V[6] + V[7]));
        // no colon after Identity-with-gaps: the reference format string
        // omits it (impl/paf.c:273)
        memcpy(b, "\tIdentity-with-gaps", 19); b += 19;
        b = write_f6(b, (float)V[6] / (float)(V[6] + V[7] + V[10] + V[11]));
        memcpy(b, "\tAligned-bases:", 15); b += 15;
        b = write_i64(b, V[6] + V[7]);
        memcpy(b, "\tQuery-inserts:", 15); b += 15;
        b = write_i64(b, V[8]);
        memcpy(b, "\tQuery-deletes:", 15); b += 15;
        b = write_i64(b, V[9]);
        *b++ = '\n';
    }
    return b - out;
}

// ------------------------------------------------- CPU column compare loop
// Reference-style per-base mismatch counting (the inner loop of
// paf_encode_mismatches, impl/paf.c:754-768) over the flat M-run arrays —
// the single-threaded C comparison point for the TPU kernel benchmark.

static unsigned char UPPER_TBL[256];
static unsigned char COMP_TBL[256];
static unsigned char UPPER_COMP_TBL[256];   // upper(comp(x)) in one lookup
static bool tables_init = false;

static void init_tables() {
    if (tables_init) return;
    for (int i = 0; i < 256; ++i) {
        UPPER_TBL[i] = (i >= 'a' && i <= 'z') ? i - 32 : i;
        COMP_TBL[i] = i;
    }
    const char* a = "acgtmrwsykvhdbnxACGTMRWSYKVHDBNX";
    const char* b = "tgcakywsrmbdhvnxTGCAKYWSRMBDHVNX";
    for (int i = 0; a[i]; ++i) COMP_TBL[(unsigned char)a[i]] = b[i];
    for (int i = 0; i < 256; ++i)
        UPPER_COMP_TBL[i] = UPPER_TBL[COMP_TBL[i]];
    tables_init = true;
}

// ------------------------------------------ batched `view -a` interleave
// Per record: its stat line (sliced from the pre-formatted blob) followed
// by the 3-row base-level alignment rendering in 150-column windows
// (paf_pretty_print2, impl/paf.c:282-314).  The caller precomputes exact
// per-record output offsets: stat_len + 3*n_cols + 3*ceil(n_cols/150).
// Threaded over records; clamped reads mirror the numpy fallback's clip.
void view_render_batch(long long n_records,
                       const long long* off, const unsigned char* ops,
                       const long long* op_lens,
                       const long long* qstart, const long long* qend,
                       const long long* tstart, const unsigned char* strand,
                       const unsigned char* pool,
                       const long long* qpool_off, const long long* tpool_off,
                       const long long* qseq_len, const long long* tseq_len,
                       const char* stat_blob, const long long* stat_off,
                       const long long* out_off, char* out,
                       long long n_threads);

void view_render_batch(long long n_records,
                       const long long* off, const unsigned char* ops,
                       const long long* op_lens,
                       const long long* qstart, const long long* qend,
                       const long long* tstart, const unsigned char* strand,
                       const unsigned char* pool,
                       const long long* qpool_off, const long long* tpool_off,
                       const long long* qseq_len, const long long* tseq_len,
                       const char* stat_blob, const long long* stat_off,
                       const long long* out_off, char* out,
                       long long n_threads) {
    init_tables();
    auto work = [&](long long r0, long long r1) {
        char tbuf[150], qbuf[150], sbuf[150];
        for (long long i = r0; i < r1; ++i) {
            char* b = out + out_off[i];
            if (stat_blob) {
                const long long sl = stat_off[i + 1] - stat_off[i];
                memcpy(b, stat_blob + stat_off[i], (size_t)sl);
                b += sl;
            }
            const unsigned char* q = pool + qpool_off[i];
            const unsigned char* t = pool + tpool_off[i];
            const long long ql = qseq_len[i], tl = tseq_len[i];
            const bool fwd = strand[i] != 0;
            long long qi = 0, tj = tstart[i];
            int w = 0;
            auto flush = [&]() {
                memcpy(b, tbuf, w); b += w; *b++ = '\n';
                memcpy(b, qbuf, w); b += w; *b++ = '\n';
                memcpy(b, sbuf, w); b += w; *b++ = '\n';
                w = 0;
            };
            auto clampq = [&](long long p) {
                return q[p < 0 ? 0 : (p >= ql ? ql - 1 : p)];
            };
            auto clampt = [&](long long p) {
                return t[p < 0 ? 0 : (p >= tl ? tl - 1 : p)];
            };
            for (long long k = off[i]; k < off[i + 1]; ++k) {
                const unsigned char op = ops[k];
                const long long L = op_lens[k];
                for (long long c = 0; c < L; ++c) {
                    unsigned char tc, qc;
                    if (op == 1) {            // query_insert: target gap
                        tc = '-';
                        qc = fwd ? clampq(qstart[i] + qi)
                                 : COMP_TBL[clampq(qend[i] - 1 - qi)];
                        ++qi;
                    } else if (op == 2) {     // query_delete: query gap
                        tc = clampt(tj++);
                        qc = '-';
                    } else {                  // M/=/X: both advance
                        tc = clampt(tj++);
                        qc = fwd ? clampq(qstart[i] + qi)
                                 : COMP_TBL[clampq(qend[i] - 1 - qi)];
                        ++qi;
                    }
                    tbuf[w] = (char)tc;
                    qbuf[w] = (char)qc;
                    sbuf[w] = UPPER_TBL[tc] == UPPER_TBL[qc] ? '*' : ' ';
                    if (++w == 150) flush();
                }
            }
            if (w) flush();
        }
    };
    if (n_threads <= 1 || n_records < 64) {
        work(0, n_records);
        return;
    }
    std::vector<std::thread> th;
    for (long long s = 0; s < n_threads; ++s)
        th.emplace_back(work, n_records * s / n_threads,
                        n_records * (s + 1) / n_threads);
    for (auto& t2 : th) t2.join();
}


static inline unsigned long long mix64(unsigned long long x) {
    x += 0x9e3779b97f4a7c15ULL;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
    return x ^ (x >> 31);
}

// Synthesize query bytes through the alignment map: copy the (possibly
// complemented) target base with a deterministic per-column substitution at
// rate (1000 - keep_per_mille)/1000.  Used by the benchmark to build
// identical host/device pools without device scatters.
void synth_query_pool(unsigned char* pool,
                      long long n_mops,
                      const long long* lens,
                      const long long* qpos0,
                      const long long* tpos0,
                      const unsigned char* rev,
                      long long keep_per_mille,
                      unsigned long long seed) {
    init_tables();
    static const char bases[4] = {'A', 'C', 'G', 'T'};
    unsigned long long col = 0;
    for (long long j = 0; j < n_mops; ++j) {
        const long long L = lens[j];
        const unsigned char* tp = pool + tpos0[j];
        unsigned char* qp = pool + qpos0[j];
        const long long step = rev[j] ? -1 : 1;
        for (long long i = 0; i < L; ++i) {
            unsigned char src = tp[i];
            if (rev[j]) src = COMP_TBL[src];
            unsigned long long r = mix64(seed + col + i);
            if ((long long)(r % 1000) >= keep_per_mille) {
                src = bases[(r >> 12) & 3];
            }
            qp[i * step] = src;
        }
        col += (unsigned long long)L * 2654435761ULL;
    }
}

// Count matching/mismatching columns per record over n_mops M runs.
void column_compare_counts(const unsigned char* pool,
                           long long n_mops,
                           const long long* lens,
                           const long long* qpos0,
                           const long long* tpos0,
                           const unsigned char* rev,
                           const long long* rec,
                           long long* m_out, long long* x_out) {
    init_tables();
    for (long long j = 0; j < n_mops; ++j) {
        const long long L = lens[j];
        const unsigned char* tp = pool + tpos0[j];
        long long m = 0;
        if (rev[j]) {
            const unsigned char* qp = pool + qpos0[j];
            for (long long i = 0; i < L; ++i) {
                m += UPPER_TBL[tp[i]] == UPPER_TBL[COMP_TBL[qp[-i]]];
            }
        } else {
            const unsigned char* qp = pool + qpos0[j];
            for (long long i = 0; i < L; ++i) {
                m += UPPER_TBL[tp[i]] == UPPER_TBL[qp[i]];
            }
        }
        m_out[rec[j]] += m;
        x_out[rec[j]] += L - m;
    }
}

// Windowed chain DP over one (qname,tname,strand) group — the host
// production path of ops/chain._group_dp (semantics of _dp_numpy /
// impl/chaining.c:150-214 exactly, including the tiebreak: among
// best-value predecessors keep the largest (target_end, query_end, index)).
// Inputs are precomputed by ops/chain._window_bounds: qe_order is the
// qend-sort permutation, [lo[i], hi[i]) its candidate slice for record i.
void chain_dp(long long n,
              const long long* qs, const long long* qe,
              const long long* ts, const long long* te,
              const long long* score,
              const long long* qe_order,
              const long long* lo, const long long* hi,
              long long gap_open, long long gap_extend, long long max_gap,
              long long* cs_out, long long* pred_out) {
    for (long long i = 0; i < n; ++i) {
        cs_out[i] = score[i];
        pred_out[i] = -1;
        long long best = LLONG_MIN, bte = 0, bqe = 0, bidx = -1;
        for (long long k = lo[i]; k < hi[i]; ++k) {
            const long long j = qe_order[k];
            if (j >= i) continue;               // processed before i only
            // window guarantees 0 <= qgap <= max_gap (ops/chain.py:97-103)
            const long long qgap = qs[i] - qe[j];
            const long long tgap = ts[i] - te[j];
            if (tgap < 0 || tgap > max_gap) continue;
            const long long g =
                (qgap + tgap == 0) ? 0 : gap_open + gap_extend * (qgap + tgap);
            if (g >= score[i]) continue;        // impl/chaining.c:195
            const long long val = score[i] + cs_out[j] - g;
            if (val > best ||
                (val == best && (te[j] > bte || (te[j] == bte &&
                 (qe[j] > bqe || (qe[j] == bqe && j > bidx)))))) {
                best = val;
                bte = te[j]; bqe = qe[j]; bidx = j;
            }
        }
        if (bidx >= 0 && best > score[i]) {
            cs_out[i] = best;
            pred_out[i] = bidx;
        }
    }
}

// Greedy chain extraction of one strand set (ops/chain.paf_chain_order;
// impl/chaining.c:88-113, 216-233).  Every array is in processing order:
// cs and pred are the DP's chain score and predecessor (a processing
// position or -1) of each record.  Records are taken best chain score
// first, ties latest processed first; each untaken record heads a chain
// that claims its predecessor links up to the first claimed record.
// Members are written head first into members_out, with chain ids from
// first_id on in extraction order, and each chain's total recomputed
// along its surviving links into scores_out.  Returns the next chain id.
// Holds no state between calls (worker threads call it at once).
long long chain_extract(long long n,
                        const long long* cs, const long long* pred,
                        const long long* qs, const long long* qe,
                        const long long* ts, const long long* te,
                        const long long* score,
                        long long gap_open, long long gap_extend,
                        long long first_id,
                        long long* members_out, long long* ids_out,
                        long long* scores_out) {
    // descending (chain score, processing position): a stable LSD radix
    // sort, a byte a pass, of each score's distance below the largest,
    // over the positions laid out latest first
    long long top = LLONG_MIN, bottom = LLONG_MAX;
    for (long long i = 0; i < n; ++i) {
        top = std::max(top, cs[i]);
        bottom = std::min(bottom, cs[i]);
    }
    const unsigned long long range =
        n ? (unsigned long long)top - (unsigned long long)bottom : 0;
    std::vector<std::pair<unsigned long long, long long>> order(n), tmp(n);
    for (long long i = 0; i < n; ++i)
        order[i] = {(unsigned long long)top - (unsigned long long)cs[n - 1 - i],
                    n - 1 - i};
    for (int shift = 0; shift < 64 && (range >> shift) != 0; shift += 8) {
        long long bucket[257] = {0};
        for (long long i = 0; i < n; ++i)
            ++bucket[((order[i].first >> shift) & 255) + 1];
        for (int b = 0; b < 256; ++b) bucket[b + 1] += bucket[b];
        for (long long i = 0; i < n; ++i)
            tmp[bucket[(order[i].first >> shift) & 255]++] = order[i];
        order.swap(tmp);
    }
    std::vector<unsigned char> claimed(n, 0);
    long long w = 0, id = first_id;
    for (long long k = 0; k < n; ++k) {
        const long long r = order[k].second;
        if (claimed[r]) continue;
        const long long head = w;
        claimed[r] = 1;
        members_out[w++] = r;
        for (long long p = pred[r]; p >= 0 && !claimed[p]; p = pred[p]) {
            claimed[p] = 1;
            members_out[w++] = p;
        }
        // get_chain_score: a record's score less the cost of the gap to
        // its predecessor, the gap free when zero
        long long total = score[members_out[head]];
        for (long long j = head; j + 1 < w; ++j) {
            const long long a = members_out[j], b = members_out[j + 1];
            const long long gap = (qs[a] - qe[b]) + (ts[a] - te[b]);
            total += score[b] - (gap == 0 ? 0 : gap_open + gap_extend * gap);
        }
        for (long long j = head; j < w; ++j) {
            ids_out[j] = id;
            scores_out[j] = total;
        }
        ++id;
    }
    return id;
}

// Materialize a coverage count array from its +/-1 diff form in one pass:
// running sum + uint16 saturation (ops/coverage.CoverageMap.counts; the
// numpy cumsum/minimum/astype chain made 5 full-array trips over a 134M-
// base chromosome).  Reference semantics: saturating uint16 counts
// (impl/paf.c:700-702).
void coverage_counts(const long long* diff, long long n,
                     long long saturation, unsigned short* out) {
    long long run = 0;
    const long long sat = saturation;
    for (long long i = 0; i < n; ++i) {
        run += diff[i];
        // min + u16 cast, exactly the numpy fallback's
        // np.minimum(cumsum, SATURATION).astype(np.uint16)
        out[i] = (unsigned short)(run > sat ? sat : run);
    }
}

// int32-diff variant (the diff values fit int32 at uint16 saturation; the
// int64 form above predates the dtype shrink and stays for compatibility).
void coverage_counts32(const int* diff, long long n,
                       long long saturation, unsigned short* out) {
    long long run = 0;
    const long long sat = saturation;
    for (long long i = 0; i < n; ++i) {
        run += diff[i];
        out[i] = (unsigned short)(run > sat ? sat : run);
    }
}

// FASTA headers and sizes (native.fasta_headers) and the sequence pool
// (fasta_pack_scan/_fill below) straight from the raw file bytes: no
// per-line Python strings and no multi-pass numpy masks.  Semantics mirror
// read_fasta:
// header = line starting '>', name = line[1:] with trailing whitespace
// stripped; sequence lines contribute their whitespace-TRIMMED span
// (interior bytes kept verbatim); content before the first header and
// empty lines are skipped.
static inline bool is_ws(char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f';
}

void fasta_scan(const char* buf, long long len,
                long long* n_records, long long* seq_bytes,
                long long* name_bytes) {
    long long recs = 0, sb = 0, nb = 0;
    bool in_rec = false;
    const char* p = buf;
    const char* end = buf + len;
    while (p < end) {
        const char* eol = (const char*)memchr(p, '\n', end - p);
        const char* le = eol ? eol : end;
        if (le > p) {
            if (*p == '>') {
                const char* ne = le;
                while (ne > p + 1 && is_ws(ne[-1])) --ne;
                nb += (ne - p - 1) + 1;  // name + NUL
                ++recs;
                in_rec = true;
            } else if (in_rec) {
                const char* s = p;
                const char* e = le;
                while (s < e && is_ws(*s)) ++s;
                while (e > s && is_ws(e[-1])) --e;
                sb += e - s;
            }
        }
        p = le + 1;
    }
    *n_records = recs;
    *seq_bytes = sb;
    *name_bytes = nb;
}

// Headers-only fill: names + trimmed sequence byte lengths in one pass,
// no pool allocation/memcpy (callers like upconvert only read fragment
// names and lengths, impl/paf_upconvert.c:27-33 — packing 100s of MB of
// bases it never looks at measured ~3 passes of pure waste).  Sizes come
// from fasta_scan.
void fasta_fill_headers(const char* buf, long long len,
                        char* name_pool, long long* name_off,
                        long long* seq_len) {
    long long rec = -1, npos = 0, cur = 0;
    const char* p = buf;
    const char* end = buf + len;
    while (p < end) {
        const char* eol = (const char*)memchr(p, '\n', end - p);
        const char* le = eol ? eol : end;
        if (le > p) {
            if (*p == '>') {
                if (rec >= 0) seq_len[rec] = cur;
                ++rec;
                cur = 0;
                const char* ne = le;
                while (ne > p + 1 && is_ws(ne[-1])) --ne;
                name_off[rec] = npos;
                memcpy(name_pool + npos, p + 1, ne - p - 1);
                npos += ne - p - 1;
                name_pool[npos++] = '\0';
            } else if (rec >= 0) {
                const char* s = p;
                const char* e = le;
                while (s < e && is_ws(*s)) ++s;
                while (e > s && is_ws(e[-1])) --e;
                cur += e - s;
            }
        }
        p = le + 1;
    }
    if (rec >= 0) seq_len[rec] = cur;
}

// The sequence pool in one threaded pass over every file's bytes
// (core/fasta.fasta_pool_from_bytes, ops/mismatch.SequencePool).  Each
// file is cut into line-aligned chunks; fasta_pack_scan counts, in
// threads, each chunk's trimmed sequence bytes before and from its first
// header, its headers and their name bytes, then prefix-sums the counts
// over all files: a chunk's leading bytes belong to the record open at its
// start, and are skipped when no earlier chunk of its file holds a header
// (the content before a file's first header).  The caller allocates the
// pool at its final size, and fasta_pack_fill writes each chunk's bases
// straight to their final offsets, in threads.  Semantics are fasta_scan's
// and fasta_fill_headers'; files are concatenated in order.
//
// A chunk is FASTA_CHUNK_FIELDS int64s: its file, its [begin, end), then
// the scan's counts, which the prefix sum turns into the fill's bases.
enum {
    CH_FILE, CH_BEGIN, CH_END,
    CH_LEAD,    // scan: sequence bytes before the chunk's first header;
                // fill: 1 when they are skipped
    CH_REST,    // scan: sequence bytes from it on; fill: the pool offset
    CH_HDRS,    // scan: headers; fill: the index of its first record
    CH_NAMES,   // scan: name bytes (NUL included); fill: its name offset
    FASTA_CHUNK_FIELDS
};

static void fasta_count_chunk(const char* p, const char* end,
                              long long* c) {
    long long lead = 0, rest = 0, hdrs = 0, names = 0;
    while (p < end) {
        const char* eol = (const char*)memchr(p, '\n', end - p);
        const char* le = eol ? eol : end;
        if (le > p) {
            if (*p == '>') {
                const char* ne = le;
                while (ne > p + 1 && is_ws(ne[-1])) --ne;
                names += (ne - p - 1) + 1;
                ++hdrs;
            } else {
                const char* s = p;
                const char* e = le;
                while (s < e && is_ws(*s)) ++s;
                while (e > s && is_ws(e[-1])) --e;
                (hdrs ? rest : lead) += e - s;
            }
        }
        p = le + 1;
    }
    c[CH_LEAD] = lead;
    c[CH_REST] = rest;
    c[CH_HDRS] = hdrs;
    c[CH_NAMES] = names;
}

static void fasta_fill_chunk(const char* p, const char* end,
                             const long long* c, unsigned char* pool,
                             char* name_pool, long long* name_off,
                             long long* seq_off) {
    bool in_rec = !c[CH_LEAD];
    long long pos = c[CH_REST], rec = c[CH_HDRS], npos = c[CH_NAMES];
    while (p < end) {
        const char* eol = (const char*)memchr(p, '\n', end - p);
        const char* le = eol ? eol : end;
        if (le > p) {
            if (*p == '>') {
                const char* ne = le;
                while (ne > p + 1 && is_ws(ne[-1])) --ne;
                name_off[rec] = npos;
                memcpy(name_pool + npos, p + 1, ne - p - 1);
                npos += ne - p - 1;
                name_pool[npos++] = '\0';
                seq_off[rec++] = pos;
                in_rec = true;
            } else if (in_rec) {
                const char* s = p;
                const char* e = le;
                while (s < e && is_ws(*s)) ++s;
                while (e > s && is_ws(e[-1])) --e;
                memcpy(pool + pos, s, e - s);
                pos += e - s;
            }
        }
        p = le + 1;
    }
}

// fn(i) for i in [0, n) on up to n_threads threads, each taking the next
// index in turn.
static void fasta_run_chunks(long long n, long long n_threads,
                             const std::function<void(long long)>& fn) {
    const long long T = std::min(n_threads, n);
    if (T <= 1) {
        for (long long i = 0; i < n; ++i) fn(i);
        return;
    }
    std::atomic<long long> next(0);
    std::vector<std::thread> th;
    for (long long t = 0; t < T; ++t)
        th.emplace_back([&] {
            for (long long i; (i = next.fetch_add(1)) < n;) fn(i);
        });
    for (auto& t : th) t.join();
}

// Cuts the files into at most n_bufs + n_threads chunks of about
// 1 / n_threads of their bytes, counts them and prefix-sums the counts.
// Fills chunks[(n_bufs + n_threads) * FASTA_CHUNK_FIELDS] and totals
// (sequence bytes, records, name bytes); returns the number of chunks.
long long fasta_pack_scan(long long n_bufs, const char* const* bufs,
                          const long long* lens, long long n_threads,
                          long long* chunks, long long* totals) {
    if (n_threads < 1) n_threads = 1;
    long long all = 0;
    for (long long f = 0; f < n_bufs; ++f) all += lens[f];
    const long long target = std::max(1LL, (all + n_threads - 1) / n_threads);
    long long n = 0;
    for (long long f = 0; f < n_bufs; ++f) {
        const char* buf = bufs[f];
        const long long len = lens[f];
        const long long k = std::max(1LL, (len + target - 1) / target);
        long long begin = 0;
        for (long long s = 1; s <= k; ++s) {
            long long cut = len;
            if (s < k) {
                // the first line start at or after the nominal cut (which
                // is at least 1: k is at most len)
                const long long at = std::max(begin, len * s / k);
                const char* nl =
                    (const char*)memchr(buf + at - 1, '\n', len - at + 1);
                cut = nl ? (nl - buf) + 1 : len;
            }
            long long* c = chunks + n++ * FASTA_CHUNK_FIELDS;
            c[CH_FILE] = f;
            c[CH_BEGIN] = begin;
            c[CH_END] = cut;
            begin = cut;
        }
    }
    fasta_run_chunks(n, n_threads, [&](long long i) {
        long long* c = chunks + i * FASTA_CHUNK_FIELDS;
        const char* buf = bufs[c[CH_FILE]];
        fasta_count_chunk(buf + c[CH_BEGIN], buf + c[CH_END], c);
    });
    long long pos = 0, rec = 0, npos = 0;
    bool seen = false;     // a header in an earlier chunk of this file
    for (long long i = 0; i < n; ++i) {
        long long* c = chunks + i * FASTA_CHUNK_FIELDS;
        if (i == 0 || c[CH_FILE] != c[CH_FILE - FASTA_CHUNK_FIELDS])
            seen = false;
        const long long lead = c[CH_LEAD], rest = c[CH_REST];
        const long long hdrs = c[CH_HDRS], names = c[CH_NAMES];
        c[CH_LEAD] = !seen;
        c[CH_REST] = pos;
        c[CH_HDRS] = rec;
        c[CH_NAMES] = npos;
        pos += (seen ? lead : 0) + rest;
        rec += hdrs;
        npos += names;
        seen = seen || hdrs > 0;
    }
    totals[0] = pos;
    totals[1] = rec;
    totals[2] = npos;
    return n;
}

// Writes the n_chunks chunks of fasta_pack_scan: the bases to pool (the
// totals' sequence bytes), the names NUL-terminated to name_pool, and
// each record's name offset, pool offset and length.
void fasta_pack_fill(const char* const* bufs, long long n_chunks,
                     const long long* chunks, long long n_threads,
                     unsigned char* pool, long long seq_bytes,
                     char* name_pool, long long n_records,
                     long long* name_off, long long* seq_off,
                     long long* seq_len) {
    fasta_run_chunks(n_chunks, n_threads, [&](long long i) {
        const long long* c = chunks + i * FASTA_CHUNK_FIELDS;
        const char* buf = bufs[c[CH_FILE]];
        fasta_fill_chunk(buf + c[CH_BEGIN], buf + c[CH_END], c, pool,
                         name_pool, name_off, seq_off);
    });
    // a record's bases end where the next record's begin: a file's bytes
    // before its first header are skipped, so across files too
    for (long long r = 0; r < n_records; ++r)
        seq_len[r] = (r + 1 < n_records ? seq_off[r + 1] : seq_bytes)
                     - seq_off[r];
}

// A regular, non-empty file mapped read-only for fasta_pack_scan/_fill:
// its address, its length in *len; null when it is not one or cannot be
// mapped (the caller then reads it).  fasta_unmap releases it.
const char* fasta_map(const char* path, long long* len) {
    const int fd = open(path, O_RDONLY | O_CLOEXEC);
    if (fd < 0) return nullptr;
    struct stat st;
    void* p = MAP_FAILED;
    if (fstat(fd, &st) == 0 && S_ISREG(st.st_mode) && st.st_size > 0)
        p = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    close(fd);
    if (p == MAP_FAILED) return nullptr;
    *len = st.st_size;
    return (const char*)p;
}

void fasta_unmap(const char* p, long long len) {
    munmap((void*)p, len);
}

// Mismatch-encode CSR rebuild, offsets half: one walk over the original
// ops computing each op's output offset (M ops contribute their =/X run
// count, taken from runs_per_mop in M-op order; everything else writes
// through op+len).  Emits out_off_per_op (n_ops+1), the M ops' output
// offsets in M-op order (for encode_runs_fill_cigar), and the pass-through
// ops/lens — replacing a ~6-pass numpy chain (contrib scatter, cumsum,
// boolean masks, two fancy scatters) over the 24M-op encode output.  With
// keep_slot null the pass-through ops/lens go to their slots of the whole
// output (new_ops/new_lens sized to it); with keep_slot they are packed in
// op order, each one's slot in keep_slot (n_ops - n_m_ops entries each),
// so that a device route moves only these and places them on the card.
void encode_rebuild_offsets(long long n_ops, const unsigned char* ops,
                            const long long* lens,
                            const long long* runs_per_mop,  // [n_m_ops]
                            long long* out_off_per_op,      // [n_ops + 1]
                            long long* m_out_off,           // [n_m_ops]
                            unsigned char* new_ops, long long* new_lens,
                            long long* keep_slot) {
    long long pos = 0, m = 0, kept = 0;
    out_off_per_op[0] = 0;
    for (long long k = 0; k < n_ops; ++k) {
        if (ops[k] == 0) {  // M: replaced by its =/X runs
            m_out_off[m] = pos;
            pos += runs_per_mop[m];
            ++m;
        } else {
            long long at = pos;
            if (keep_slot) {
                keep_slot[kept] = pos;
                at = kept++;
            }
            new_ops[at] = ops[k];
            new_lens[at] = lens[k];
            ++pos;
        }
        out_off_per_op[k + 1] = pos;
    }
}

// Interval scatter into a coverage diff array: d[start[i]]++, d[end[i]]--
// for the selected runs (ops/coverage.CoverageMap.add; np.add.at measured
// ~1.7 s for 3M updates — the ufunc.at dispatch is per-element Python-C
// transitions, this loop is ~30 ms).
void coverage_add(int* diff, const long long* starts, const long long* ends,
                  long long n) {
    for (long long i = 0; i < n; ++i) {
        ++diff[starts[i]];
        --diff[ends[i]];
    }
}

// Run-length encode a uint16 count array (write_bed's equal-count runs,
// impl/paf_to_bed.c:33-55; binary mode splits on the >0 indicator).  Two
// passes: rle_u16_count sizes the output, rle_u16_fill writes
// starts/ends/vals.  Replaces a numpy chain that materialized an int64
// key + boundary compare + nonzero over a 134M-base chromosome (~7 s);
// both passes together read the u16 array twice at memory speed.
long long rle_u16_count(const unsigned short* counts, long long n,
                        long long binary) {
    if (n == 0) return 0;
    long long runs = 1;
    unsigned short prev = binary ? (unsigned short)(counts[0] > 0)
                                 : counts[0];
    for (long long i = 1; i < n; ++i) {
        const unsigned short k = binary ? (unsigned short)(counts[i] > 0)
                                        : counts[i];
        runs += (k != prev);
        prev = k;
    }
    return runs;
}

void rle_u16_fill(const unsigned short* counts, long long n,
                  long long binary, long long* starts, long long* ends,
                  long long* vals) {
    if (n == 0) return;
    long long r = 0;
    starts[0] = 0;
    vals[0] = counts[0];
    unsigned short prev = binary ? (unsigned short)(counts[0] > 0)
                                 : counts[0];
    for (long long i = 1; i < n; ++i) {
        const unsigned short k = binary ? (unsigned short)(counts[i] > 0)
                                        : counts[i];
        if (k != prev) {
            ends[r] = i;
            ++r;
            starts[r] = i;
            vals[r] = counts[i];
            prev = k;
        }
    }
    ends[r] = n;
}

// Batch validation (core/pafio.paf_check <-> impl/paf.c:427-461): bounds
// checks plus cigar query/target consumption vs end-start.  Returns the
// first bad record index (writing its error code 0..5 to *code) or -1.
long long paf_check_batch(long long n_records, const long long* off,
                          const unsigned char* ops, const long long* lens,
                          const long long* qstart, const long long* qend,
                          const long long* qlen,
                          const long long* tstart, const long long* tend,
                          const long long* tlen,
                          const unsigned char* has_cigar,
                          long long* code) {
    for (long long r = 0; r < n_records; ++r) {
        if (qstart[r] < 0 || qstart[r] >= qlen[r]) { *code = 0; return r; }
        if (qstart[r] > qend[r] || qend[r] > qlen[r]) { *code = 1; return r; }
        if (tstart[r] < 0 || tstart[r] >= tlen[r]) { *code = 2; return r; }
        if (tstart[r] > tend[r] || tend[r] > tlen[r]) { *code = 3; return r; }
        if (!has_cigar[r]) continue;
        long long q = 0, t = 0;
        for (long long k = off[r]; k < off[r + 1]; ++k) {
            if (ops[k] != 2) q += lens[k];   // all but query_delete
            if (ops[k] != 1) t += lens[k];   // all but query_insert
        }
        if (q != qend[r] - qstart[r]) { *code = 4; return r; }
        if (t != tend[r] - tstart[r]) { *code = 5; return r; }
    }
    return -1;
}

// Aligned-run query intervals of a batch (ops/coverage.match_intervals):
// one entry per M/=/X run, query coordinates by the reference's forward
// walk from query_start (impl/paf.c:690-709).  Caller allocates rec/start/
// end of size n_ops; returns the filled count.  Op codes: 1 = query
// insert (advances query only), 2 = query delete (advances target only).
long long match_intervals(long long n_records, const long long* off,
                          const unsigned char* ops, const long long* lens,
                          const long long* qstart,
                          long long* rec, long long* start, long long* end) {
    long long out = 0;
    for (long long r = 0; r < n_records; ++r) {
        long long q = qstart[r];
        for (long long k = off[r]; k < off[r + 1]; ++k) {
            const unsigned char op = ops[k];
            if (op != 1 && op != 2) {       // aligned: M / = / X
                rec[out] = r;
                start[out] = q;
                end[out] = q + lens[k];
                ++out;
            }
            if (op != 2) q += lens[k];      // all but query_delete advance
        }
    }
    return out;
}

// K5's interval arguments (ops/tile.sweep_arguments): the walk of
// match_intervals, with each record's touching aligned runs joined into one
// interval per maximal stretch of aligned query bases (a run that starts
// where the last one ended extends it, across a D; an I that advances the
// query breaks it) and zero-length runs dropped, so a record's intervals
// are disjoint, ascending and cover the same bases.  Writes the CSR offsets
// run_off (n_records + 1) and start/end, which the caller sizes to n_ops;
// *n_runs gets the aligned runs read.  Returns the intervals written.
long long tile_intervals(long long n_records, const long long* off,
                         const unsigned char* ops, const long long* lens,
                         const long long* qstart, long long* run_off,
                         long long* start, long long* end,
                         long long* n_runs) {
    long long out = 0, runs = 0;
    run_off[0] = 0;
    for (long long r = 0; r < n_records; ++r) {
        long long q = qstart[r], s = 0, e = 0;   // the open stretch [s, e)
        bool open = false;
        for (long long k = off[r]; k < off[r + 1]; ++k) {
            const unsigned char op = ops[k];
            const long long len = lens[k];
            if (op != 1 && op != 2) {       // aligned: M / = / X
                ++runs;
                if (len > 0) {
                    if (!open || e != q) {  // not touching: a new stretch
                        if (open) {
                            start[out] = s;
                            end[out] = e;
                            ++out;
                        }
                        s = q;
                        open = true;
                    }
                    e = q + len;
                }
            }
            if (op != 2) q += len;          // all but query_delete advance
        }
        if (open) {
            start[out] = s;
            end[out] = e;
            ++out;
        }
        run_off[r + 1] = out;
    }
    *n_runs = runs;
    return out;
}

// Per-record unreliable-tail prefix-trim decision — the host production
// path of ops/tailtrim._trim_counts (Bob Harris algorithm prefix half,
// impl/paf.c:811-904).  Exact semantics of the numpy form: identities are
// float32 divisions (NaN/inf comparisons fall out false as in IEEE), the
// max_trim break runs BEFORE the op's identity test, trim_idx is the LAST
// low-prefix op, and the re-included suffix start is the SMALLEST k whose
// suffix identity >= the whole-record identity.
// ``rev`` (nullable) flips the scan direction per record: the suffix pass
// runs on the logically INVERTED record — same op order for same-strand
// records, reversed for opposite-strand (paf_invert reverses the cigar
// only when !same_strand, impl/paf.c:487-489) — without materializing the
// inverted table.
void trim_counts(long long n_records, const long long* off,
                 const unsigned char* is_match, const long long* lens,
                 const float* thr, const float* ident,
                 const long long* max_trim, const unsigned char* rev,
                 long long* out) {
    for (long long r = 0; r < n_records; ++r) {
        const long long o0 = off[r], o1 = off[r + 1], n = o1 - o0;
        const bool bw = rev != nullptr && rev[r];
        const long long base = bw ? o1 - 1 : o0;
        const long long step = bw ? -1 : 1;
        long long pm = 0, pmm = 0, trim_idx = -1, pm_ti = 0, pmm_ti = 0;
        for (long long j = 0; j < n; ++j) {
            const long long k = base + step * j;
            if (is_match[k]) pm += lens[k]; else pmm += lens[k];
            const long long cols = pm + pmm;
            if (max_trim[r] >= 0 && cols > max_trim[r]) break;
            if ((float)pm / (float)cols < thr[r]) {
                trim_idx = j;
                pm_ti = pm;
                pmm_ti = pmm;
            }
        }
        if (trim_idx < 0) { out[r] = 0; continue; }
        long long best = trim_idx + 1, bm = 0, bmm = 0;
        for (long long j = 0; j <= trim_idx; ++j) {
            const long long k = base + step * j;
            const long long suf_m = pm_ti - bm, suf_mm = pmm_ti - bmm;
            if ((float)suf_m / (float)(suf_m + suf_mm) >= ident[r]) {
                best = j;
                break;
            }
            if (is_match[k]) bm += lens[k]; else bmm += lens[k];
        }
        out[r] = best;
    }
}

// One Bob Harris trim decision over a directed op walk (the loop of
// trim_counts above, with is_match derived from the op codes: M==0, '='==3).
static long long trim_decide_dir(const unsigned char* ops,
                                 const long long* lens,
                                 long long base, long long step, long long n,
                                 float thr, float ident, long long max_trim) {
    long long pm = 0, pmm = 0, trim_idx = -1, pm_ti = 0, pmm_ti = 0;
    for (long long j = 0; j < n; ++j) {
        const long long k = base + step * j;
        const bool m = ops[k] == 0 || ops[k] == 3;
        if (m) pm += lens[k]; else pmm += lens[k];
        const long long cols = pm + pmm;
        if (max_trim >= 0 && cols > max_trim) break;
        if ((float)pm / (float)cols < thr) {
            trim_idx = j;
            pm_ti = pm;
            pmm_ti = pmm;
        }
    }
    if (trim_idx < 0) return 0;
    long long best = trim_idx + 1, bm = 0, bmm = 0;
    for (long long j = 0; j <= trim_idx; ++j) {
        const long long k = base + step * j;
        const long long suf_m = pm_ti - bm, suf_mm = pmm_ti - bmm;
        if ((float)suf_m / (float)(suf_m + suf_mm) >= ident) {
            best = j;
            break;
        }
        if (ops[k] == 0 || ops[k] == 3) bm += lens[k]; else bmm += lens[k];
    }
    return best;
}

// Whole-batch unreliable-tail trim: both Bob Harris passes (decision AND
// apply) in one threaded sweep — the host production path of
// ops/tailtrim.trim_unreliable_tails (impl/paf.c:811-953).  Because the
// suffix pass runs on the logically INVERTED record (op order reversed
// only for '-' records, paf_invert's rule at impl/paf.c:487-489), the
// kept ops of every record are one CONTIGUOUS range [keep_a, keep_b) of
// the input CSR: '+' records drop tc1+tc2 leading ops, '-' records drop
// tc1 leading and tc2 trailing ops.  dq*/dt* are the query-/target-
// consuming base sums of each pass's dropped ops in ORIGINAL orientation
// (op 2 'D' consumes no query, op 1 'I' consumes no target); the caller
// applies the strand-aware coordinate updates and rebuilds the CSR with
// copy_op_ranges.  The whole-record identity / threshold / max_trim are
// computed here per record with the exact mixed float32/double arithmetic
// of the Python oracle (float casts mirror impl/paf.c:832,886,923) and
// shared by both passes, exactly as in the form this replaces (verified
// byte-identical against the compiled reference by
// tests/test_reference_diff.py).
void trim_tails_apply(long long n_records, const long long* off,
                      const unsigned char* ops, const long long* lens,
                      const unsigned char* strand,  // 1 iff '+'
                      float score_fraction, float max_fraction,
                      long long* keep_a, long long* keep_b,
                      long long* dq1, long long* dt1,
                      long long* dq2, long long* dt2,
                      long long n_threads) {
    auto work = [&](long long r0, long long r1) {
        for (long long r = r0; r < r1; ++r) {
            const long long o0 = off[r], o1 = off[r + 1];
            long long tot_m = 0, tot_mm = 0;
            for (long long k = o0; k < o1; ++k) {
                if (ops[k] == 0 || ops[k] == 3) tot_m += lens[k];
                else tot_mm += lens[k];
            }
            const long long cols = tot_m + tot_mm;
            const float i_ = (float)tot_m / (float)cols;  // NaN when cols==0
            const float t_ =
                (float)((double)i_ - (double)i_ * (double)score_fraction);
            const long long mt =
                (long long)truncf((float)cols * max_fraction);
            // pass 1: prefix decision + dropped-base sums
            const long long tc1 =
                trim_decide_dir(ops, lens, o0, 1, o1 - o0, t_, i_, mt);
            long long q1 = 0, t1 = 0;
            for (long long k = o0; k < o0 + tc1; ++k) {
                if (ops[k] != 2) q1 += lens[k];
                if (ops[k] != 1) t1 += lens[k];
            }
            const long long a = o0 + tc1;
            // pass 2 on the logically inverted remainder
            long long tc2, a2, b2;
            if (strand[r]) {
                tc2 = trim_decide_dir(ops, lens, a, 1, o1 - a, t_, i_, mt);
                a2 = a + tc2;
                b2 = o1;
                keep_a[r] = a2;
                keep_b[r] = b2;
                a2 = a;              // dropped range [a, a+tc2)
                b2 = a + tc2;
            } else {
                tc2 = trim_decide_dir(ops, lens, o1 - 1, -1, o1 - a, t_, i_,
                                      mt);
                keep_a[r] = a;
                keep_b[r] = o1 - tc2;
                a2 = o1 - tc2;       // dropped range [o1-tc2, o1)
                b2 = o1;
            }
            long long q2 = 0, t2 = 0;
            for (long long k = a2; k < b2; ++k) {
                if (ops[k] != 2) q2 += lens[k];
                if (ops[k] != 1) t2 += lens[k];
            }
            dq1[r] = q1;
            dt1[r] = t1;
            dq2[r] = q2;
            dt2[r] = t2;
        }
    };
    if (n_threads <= 1 || n_records < 1024) {
        work(0, n_records);
        return;
    }
    std::vector<std::thread> th;
    for (long long s = 0; s < n_threads; ++s) {
        const long long r0 = n_records * s / n_threads;
        const long long r1 = n_records * (s + 1) / n_threads;
        th.emplace_back(work, r0, r1);
    }
    for (auto& t : th) t.join();
}

// Whole-batch unreliable-tail trim over RAW cigar text: tokenize each
// record's cg:Z bytes into per-thread scratch, run the exact
// trim_tails_apply decision pair (same float arithmetic, same strand
// quirk), and report the KEPT text as a byte subrange of the input —
// trim only ever drops whole ops from the ends, so the kept cigar is a
// contiguous substring and no text is rewritten.  Outputs: new cg byte
// range [cg_a, cg_a+cg_n) and the four dropped-base sums for the
// caller's strand-aware coordinate updates (paf_trim_unreliable_tails,
// impl/paf.c:811-953; paf_trim.c reads with parse_cigar=1 and
// re-serializes, which the raw-mode serializer reproduces).
void trim_tails_raw(long long n_records, const char* buf,
                    const long long* cg_start, const long long* cg_len,
                    const unsigned char* strand,  // 1 iff '+'
                    float score_fraction, float max_fraction,
                    long long* cg_a, long long* cg_n,
                    long long* dq1, long long* dt1,
                    long long* dq2, long long* dt2,
                    long long n_threads) {
    auto work = [&](long long r0, long long r1) {
        std::vector<unsigned char> ops_s;
        std::vector<long long> lens_s, tok_s;
        for (long long r = r0; r < r1; ++r) {
            const char* p = buf + cg_start[r];
            const char* e = p + cg_len[r];
            ops_s.clear(); lens_s.clear(); tok_s.clear();
            long long tot_m = 0, tot_mm = 0;
            while (p < e) {
                tok_s.push_back(p - (buf + cg_start[r]));
                long long L = 0;
                while (p < e && *p >= '0' && *p <= '9')
                    L = L * 10 + (*p++ - '0');
                if (p >= e) break;
                const char c = *p++;
                unsigned char op = 0;
                switch (c) {
                    case 'M': op = 0; break;
                    case 'I': op = 1; break;
                    case 'D': op = 2; break;
                    case '=': op = 3; break;
                    case 'X': op = 4; break;
                }
                ops_s.push_back(op);
                lens_s.push_back(L);
                if (op == 0 || op == 3) tot_m += L; else tot_mm += L;
            }
            tok_s.push_back(cg_len[r]);
            const long long n = (long long)ops_s.size();
            const long long cols = tot_m + tot_mm;
            const float i_ = (float)tot_m / (float)cols;  // NaN if cols==0
            const float t_ =
                (float)((double)i_ - (double)i_ * (double)score_fraction);
            const long long mt =
                (long long)truncf((float)cols * max_fraction);
            const unsigned char* ops = ops_s.data();
            const long long* lens = lens_s.data();
            const long long tc1 =
                trim_decide_dir(ops, lens, 0, 1, n, t_, i_, mt);
            long long q1 = 0, t1 = 0;
            for (long long k = 0; k < tc1; ++k) {
                if (ops[k] != 2) q1 += lens[k];
                if (ops[k] != 1) t1 += lens[k];
            }
            long long tc2, keep_a, keep_b, a2, b2;
            if (strand[r]) {
                tc2 = trim_decide_dir(ops, lens, tc1, 1, n - tc1, t_, i_,
                                      mt);
                keep_a = tc1 + tc2; keep_b = n;
                a2 = tc1; b2 = tc1 + tc2;
            } else {
                tc2 = trim_decide_dir(ops, lens, n - 1, -1, n - tc1, t_, i_,
                                      mt);
                keep_a = tc1; keep_b = n - tc2;
                a2 = n - tc2; b2 = n;
            }
            long long q2 = 0, t2 = 0;
            for (long long k = a2; k < b2; ++k) {
                if (ops[k] != 2) q2 += lens[k];
                if (ops[k] != 1) t2 += lens[k];
            }
            cg_a[r] = cg_start[r] + tok_s[keep_a];
            cg_n[r] = tok_s[keep_b] - tok_s[keep_a];
            dq1[r] = q1; dt1[r] = t1; dq2[r] = q2; dt2[r] = t2;
        }
    };
    if (n_threads <= 1 || n_records < 1024) {
        work(0, n_records);
        return;
    }
    std::vector<std::thread> th;
    for (long long s = 0; s < n_threads; ++s) {
        const long long r0 = n_records * s / n_threads;
        const long long r1 = n_records * (s + 1) / n_threads;
        th.emplace_back(work, r0, r1);
    }
    for (auto& t : th) t.join();
}

// Validation walks mirroring the reference's assert semantics (one pass
// per batch; the numpy forms in ops/transforms are the oracles and
// no-toolchain fallbacks).

// First record violating the query-side coverage-walk asserts of
// tile/to_bed (impl/paf.c:691-709, impl/paf_tile.c:44-60), or -1:
// aligned (M/=/X) columns must stay in [0, qend) and [0, qlen); the walk
// (I advances, D does not) must end exactly at qend.  Name-consistency
// is the caller's (needs the name table).
long long query_walk_violation(long long n_records, const long long* off,
                               const unsigned char* ops,
                               const long long* lens,
                               const long long* qstart,
                               const long long* qend,
                               const long long* qlen) {
    for (long long r = 0; r < n_records; ++r) {
        long long i = qstart[r];
        bool bad = false;
        for (long long k = off[r]; k < off[r + 1] && !bad; ++k) {
            const unsigned char op = ops[k];
            const long long L = lens[k];
            if (op == 2) continue;               // D: cursor unmoved
            if (op != 1 && L > 0) {              // aligned columns [i, i+L)
                if (i < 0 || i + L > qend[r] || i + L > qlen[r]) bad = true;
            }
            i += L;
        }
        if (bad || i != qend[r]) return r;
    }
    return -1;
}

// (kind, record) of the first record the reference's shatter walk would
// die on (impl/paf.c:600-663): kind 1 = assert abort (length < 1, =/X
// op, end-of-walk span mismatch), kind 2 = per-shard paf_check errAbort
// (shard coordinates out of bounds).  Returns -1 clean, else the record,
// with *kind_out set.  Per record the first failing op decides the kind;
// the span asserts fire only after the whole walk.
long long shatter_violation(long long n_records, const long long* off,
                            const unsigned char* ops, const long long* lens,
                            const unsigned char* strand,
                            const long long* qstart, const long long* qend,
                            const long long* qlen,
                            const long long* tstart, const long long* tend,
                            const long long* tlen, long long* kind_out) {
    for (long long r = 0; r < n_records; ++r) {
        long long q = strand[r] ? qstart[r] : qend[r];
        long long t = tstart[r];
        for (long long k = off[r]; k < off[r + 1]; ++k) {
            const unsigned char op = ops[k];
            const long long L = lens[k];
            if (L < 1 || op == 3 || op == 4) { *kind_out = 1; return r; }
            if (op == 0) {
                const long long sq = strand[r] ? q : q - L;
                if (sq < 0 || sq + L > qlen[r]
                    || t < 0 || t + L > tlen[r]) {
                    *kind_out = 2;
                    return r;
                }
                q += strand[r] ? L : -L;
                t += L;
            } else if (op == 1) {
                q += strand[r] ? L : -L;
            } else {
                t += L;
            }
        }
        if (t != tend[r] || q != (strand[r] ? qend[r] : qstart[r])) {
            *kind_out = 1;
            return r;
        }
    }
    return -1;
}

// Gather contiguous op ranges [a[r], b[r]) into a compact CSR whose record
// offsets are new_off (caller-cumsummed from b-a) — one memcpy pair per
// record, threaded over records.  Generic CSR-rebuild helper (trim, and any
// transform whose kept ops stay contiguous per record).
void copy_op_ranges(long long n_records, const long long* a,
                    const long long* b, const long long* new_off,
                    const unsigned char* ops, const long long* lens,
                    unsigned char* new_ops, long long* new_lens,
                    long long n_threads) {
    auto work = [&](long long r0, long long r1) {
        for (long long r = r0; r < r1; ++r) {
            const long long n = b[r] - a[r];
            if (n <= 0) continue;
            memcpy(new_ops + new_off[r], ops + a[r], (size_t)n);
            memcpy(new_lens + new_off[r], lens + a[r],
                   (size_t)n * sizeof(long long));
        }
    };
    if (n_threads <= 1 || n_records < 1024) {
        work(0, n_records);
        return;
    }
    std::vector<std::thread> th;
    for (long long s = 0; s < n_threads; ++s) {
        const long long r0 = n_records * s / n_threads;
        const long long r1 = n_records * (s + 1) / n_threads;
        th.emplace_back(work, r0, r1);
    }
    for (auto& t : th) t.join();
}

// Shatter walk: one pass over the CSR emitting, per M op, the source
// record index and the shard's query/target coordinates (paf_shatter2's
// coordinate walk, impl/paf.c:600-663: query advances forward for '+' and
// backward from qend for '-'; target always forward).  Caller counts M
// ops first (k) and allocates; the remaining columns are plain [rec]
// gathers in numpy.  Threaded over records: every record's output slot
// base is its exclusive M-count prefix, precomputed by the caller in
// m_base.
void shatter_walk(long long n_records, const long long* off,
                  const unsigned char* ops, const long long* lens,
                  const long long* qstart, const long long* qend,
                  const long long* tstart, const unsigned char* strand,
                  const long long* m_base,
                  long long* rec, long long* qs, long long* ts,
                  long long* ln, long long n_threads) {
    auto work = [&](long long r0, long long r1) {
        for (long long r = r0; r < r1; ++r) {
            long long w = m_base[r];
            long long q = 0, t = tstart[r];
            const bool fwd = strand[r];
            for (long long k = off[r]; k < off[r + 1]; ++k) {
                const unsigned char op = ops[k];
                const long long L = lens[k];
                if (op == 0) {  // M
                    rec[w] = r;
                    qs[w] = fwd ? qstart[r] + q : qend[r] - q - L;
                    ts[w] = t;
                    ln[w] = L;
                    ++w;
                }
                if (op != 2) q += L;  // advances query unless D
                if (op != 1) t += L;  // advances target unless I
            }
        }
    };
    if (n_threads <= 1 || n_records < 1024) {
        work(0, n_records);
        return;
    }
    std::vector<std::thread> th;
    for (long long s = 0; s < n_threads; ++s)
        th.emplace_back(work, n_records * s / n_threads,
                        n_records * (s + 1) / n_threads);
    for (auto& t : th) t.join();
}

// Interleave 13 int64 column arrays into a row-major [n,13] matrix (the
// serializer's record layout) in one pass — np column assignment into a
// [n,13] matrix is 13 strided write passes.
void pack_ints13(long long n, const long long* const* cols,
                 long long* out, long long n_threads) {
    auto work = [&](long long r0, long long r1) {
        for (long long i = r0; i < r1; ++i) {
            long long* R = out + i * 13;
            for (int j = 0; j < 13; ++j) R[j] = cols[j][i];
        }
    };
    if (n_threads <= 1 || n < 4096) {
        work(0, n);
        return;
    }
    std::vector<std::thread> th;
    for (long long s = 0; s < n_threads; ++s)
        th.emplace_back(work, n * s / n_threads, n * (s + 1) / n_threads);
    for (auto& t : th) t.join();
}

// Fused cigar invert: relabel I<->D and reverse op order for records with
// rev[r] set (paf_invert's cigar half, impl/paf.c:469-490 — order flips
// only for opposite-strand records).  One threaded pass replaces the
// numpy permutation build (arange + cumsum + two fancy gathers over ALL
// ops when any record needs reversing).
void invert_ops(long long n_records, const long long* off,
                const unsigned char* ops, const long long* lens,
                const unsigned char* rev,
                unsigned char* new_ops, long long* new_lens,
                long long n_threads) {
    auto work = [&](long long r0, long long r1) {
        for (long long r = r0; r < r1; ++r) {
            const long long o0 = off[r], o1 = off[r + 1];
            if (rev[r]) {
                for (long long k = o0; k < o1; ++k) {
                    const long long j = o1 - 1 - (k - o0);
                    const unsigned char op = ops[j];
                    new_ops[k] = op == 1 ? 2 : (op == 2 ? 1 : op);
                    new_lens[k] = lens[j];
                }
            } else {
                for (long long k = o0; k < o1; ++k) {
                    const unsigned char op = ops[k];
                    new_ops[k] = op == 1 ? 2 : (op == 2 ? 1 : op);
                }
                memcpy(new_lens + o0, lens + o0,
                       (size_t)(o1 - o0) * sizeof(long long));
            }
        }
    };
    if (n_threads <= 1 || n_records < 1024) {
        work(0, n_records);
        return;
    }
    std::vector<std::thread> th;
    for (long long s = 0; s < n_threads; ++s) {
        const long long r0 = n_records * s / n_threads;
        const long long r1 = n_records * (s + 1) / n_threads;
        th.emplace_back(work, r0, r1);
    }
    for (auto& t : th) t.join();
}

// Greedy tile sweep over a pre-packed uint16 coverage arena — the host
// production path of ops/tile._assign_tile_levels_host (semantics of
// impl/paf_tile.c:36-93,164-175: best-first order, per-base saturating
// increments, tile level = median post-increment count over the record's
// matched query bases; runs of one record are disjoint, so per-run
// increments equal the numpy mask add).  arena_off[i] is the arena offset
// of record i's sequence; [run_off[i], run_off[i+1]) index istart/iend
// (absolute query coords).  levels_out is only written for covered records
// (caller presets the empty-match sentinel).
void tile_sweep(long long n_order, const long long* order,
                const long long* arena_off,
                const long long* run_off,
                const long long* istart, const long long* iend,
                unsigned short* arena, long long saturation,
                long long* levels_out) {
    std::vector<unsigned short> vals;
    const unsigned short sat = (unsigned short)saturation;
    for (long long oi = 0; oi < n_order; ++oi) {
        const long long i = order[oi];
        const long long r0 = run_off[i], r1 = run_off[i + 1];
        if (r0 == r1) continue;
        vals.clear();
        for (long long r = r0; r < r1; ++r) {
            unsigned short* w = arena + arena_off[i];
            for (long long p = istart[r]; p < iend[r]; ++p) {
                unsigned short c = w[p];
                c = c < sat ? (unsigned short)(c + 1) : sat;
                w[p] = c;
                vals.push_back(c);
            }
        }
        if (vals.empty()) continue;
        const long long k = ((long long)vals.size() + 1) / 2;
        std::nth_element(vals.begin(), vals.begin() + (k - 1), vals.end());
        levels_out[i] = (long long)vals[k - 1];
    }
}

// Threaded per-record column counts — the PRODUCTION counts path when the
// router predicts the host beats the device end-to-end (upload-bound
// tunnels, see ops/mismatch._device_counts_predicted_faster).  Shards the
// mop range column-balanced; each thread accumulates into a private
// [n_records] pair and the partials sum afterwards (integer adds — result
// identical to the sequential pass).  column_compare_counts above stays
// single-threaded by design: it is the benchmark's reference C loop.
void column_compare_counts_mt(const unsigned char* pool,
                              long long n_mops,
                              const long long* lens,
                              const long long* qpos0,
                              const long long* tpos0,
                              const unsigned char* rev,
                              const long long* rec,
                              long long n_records,
                              long long* m_out, long long* x_out,
                              long long n_threads) {
    if (n_threads <= 1 || n_mops < 256) {
        column_compare_counts(pool, n_mops, lens, qpos0, tpos0, rev, rec,
                              m_out, x_out);
        return;
    }
    init_tables();
    long long total = 0;
    for (long long j = 0; j < n_mops; ++j) total += lens[j];
    std::vector<long long> jb(n_threads + 1, n_mops);
    jb[0] = 0;
    {
        long long j = 0, col = 0;
        for (long long s = 1; s < n_threads; ++s) {
            const long long target = total * s / n_threads;
            while (j < n_mops && col < target) col += lens[j++];
            jb[s] = j;
        }
    }
    std::vector<long long> partial((size_t)(2 * n_threads * n_records), 0);
    std::vector<std::thread> th;
    for (long long s = 0; s < n_threads; ++s) {
        th.emplace_back([&, s] {
            long long* pm = partial.data() + 2 * s * n_records;
            long long* px = pm + n_records;
            column_compare_counts(pool, jb[s + 1] - jb[s], lens + jb[s],
                                  qpos0 + jb[s], tpos0 + jb[s], rev + jb[s],
                                  rec + jb[s], pm, px);
        });
    }
    for (auto& t : th) t.join();
    for (long long s = 0; s < n_threads; ++s) {
        const long long* pm = partial.data() + 2 * s * n_records;
        const long long* px = pm + n_records;
        for (long long r = 0; r < n_records; ++r) {
            m_out[r] += pm[r];
            x_out[r] += px[r];
        }
    }
}

// One shard of the =/X run decomposition: ops [j0, j1), with col0 the
// global column index of op j0's first column and (when filling) the runs
// written from out index run0.  Returns the shard's run count.
static long long encode_runs_shard(const unsigned char* pool,
                                   long long j0, long long j1,
                                   const long long* lens,
                                   const long long* qpos0,
                                   const long long* tpos0,
                                   const unsigned char* rev,
                                   long long col0, long long run0,
                                   long long* starts, unsigned char* vals) {
    long long nruns = run0, col = col0;
    for (long long j = j0; j < j1; ++j) {
        const long long L = lens[j];
        const unsigned char* tp = pool + tpos0[j];
        const unsigned char* qp = pool + qpos0[j];
        const long long step = rev[j] ? -1 : 1;
        const bool rc = rev[j] != 0;
        int prev = -1;
        for (long long i = 0; i < L; ++i) {
            unsigned char qb = qp[i * step];
            if (rc) qb = COMP_TBL[qb];
            const int m = UPPER_TBL[tp[i]] == UPPER_TBL[qb];
            if (m != prev) {
                if (starts) {
                    starts[nruns] = col + i;
                    vals[nruns] = (unsigned char)m;
                }
                ++nruns;
                prev = m;
            }
        }
        col += L;
    }
    return nruns - run0;
}

// Emit the =/X run decomposition over the flat M-run arrays in the compact
// (run-start global column index, match state) format of ops/tiled.tiled_runs
// (reference walk: paf_encode_mismatches, impl/paf.c:748-777).  Pass
// starts=NULL to count only; returns the number of runs.  This is the
// production extraction path: the run list must land on the host for the
// CSR rebuild anyway, and a host pass over the pool beats device extraction
// + an O(runs) device->host transfer.  Parallelized over column-balanced op
// shards (run boundaries never cross ops, so shards are independent and the
// output is byte-identical to the sequential pass).  Two-call protocol:
// call 1 with starts=NULL counts and fills shard_counts[n_threads]; call 2
// with starts/vals and the SAME n_threads + shard_counts fills in one pass
// (shard bounds are recomputed deterministically).  n_threads <= 1 runs
// inline and ignores shard_counts.  NB: column_compare_counts stays
// single-threaded by design — it is the benchmark's reference C loop.
long long column_encode_runs(const unsigned char* pool,
                             long long n_mops,
                             const long long* lens,
                             const long long* qpos0,
                             const long long* tpos0,
                             const unsigned char* rev,
                             long long* starts,
                             unsigned char* vals,
                             long long n_threads,
                             long long* shard_counts) {
    init_tables();
    if (n_threads <= 1 || n_mops < 1024) {
        return encode_runs_shard(pool, 0, n_mops, lens, qpos0, tpos0, rev,
                                 0, 0, starts, vals);
    }
    // column-balanced shard bounds (deterministic across both calls)
    long long total = 0;
    for (long long j = 0; j < n_mops; ++j) total += lens[j];
    std::vector<long long> jb(n_threads + 1, n_mops), cb(n_threads + 1, 0);
    jb[0] = 0;
    {
        long long j = 0, col = 0;
        for (long long s = 1; s < n_threads; ++s) {
            const long long target = total * s / n_threads;
            while (j < n_mops && col < target) col += lens[j++];
            jb[s] = j;
            cb[s] = col;
        }
        cb[n_threads] = total;
    }
    std::vector<std::thread> th;
    if (!starts) {                       // count pass
        std::vector<long long> counts(n_threads, 0);
        for (long long s = 0; s < n_threads; ++s) {
            th.emplace_back([&, s] {
                counts[s] = encode_runs_shard(pool, jb[s], jb[s + 1], lens,
                                              qpos0, tpos0, rev, cb[s], 0,
                                              nullptr, nullptr);
            });
        }
        for (auto& t : th) t.join();
        long long tot_runs = 0;
        for (long long s = 0; s < n_threads; ++s) {
            if (shard_counts) shard_counts[s] = counts[s];
            tot_runs += counts[s];
        }
        return tot_runs;
    }
    // fill pass: offsets from the caller-provided shard counts
    std::vector<long long> off(n_threads + 1, 0);
    for (long long s = 0; s < n_threads; ++s)
        off[s + 1] = off[s] + shard_counts[s];
    for (long long s = 0; s < n_threads; ++s) {
        th.emplace_back([&, s] {
            encode_runs_shard(pool, jb[s], jb[s + 1], lens, qpos0, tpos0,
                              rev, cb[s], off[s], starts, vals);
        });
    }
    for (auto& t : th) t.join();
    return off[n_threads];
}

// ------------------------------------------ direct CSR-form run extraction
// The compact (starts, vals) form above still needs an O(runs) numpy rebuild
// (searchsorted + add.at over tens of millions of runs — measured several
// seconds at 27M runs).  These two passes skip it: count runs per M op, then
// write each op's (=/X, length) runs straight into the output cigar arrays
// at caller-computed destination offsets.  Parallel over mop ranges (each
// mop's runs are independent).

static void mop_range_bounds(long long n_mops, const long long* lens,
                             long long n_threads, std::vector<long long>& jb) {
    long long total = 0;
    for (long long j = 0; j < n_mops; ++j) total += lens[j];
    jb.assign(n_threads + 1, n_mops);
    jb[0] = 0;
    long long j = 0, col = 0;
    for (long long s = 1; s < n_threads; ++s) {
        const long long target = total * s / n_threads;
        while (j < n_mops && col < target) col += lens[j++];
        jb[s] = j;
    }
}

static void count_runs_shard(const unsigned char* pool,
                             long long j0, long long j1,
                             const long long* lens, const long long* qpos0,
                             const long long* tpos0, const unsigned char* rev,
                             long long* runs_per_mop) {
    for (long long j = j0; j < j1; ++j) {
        const long long L = lens[j];
        const unsigned char* tp = pool + tpos0[j];
        const unsigned char* qp = pool + qpos0[j];
        const long long step = rev[j] ? -1 : 1;
        const bool rc = rev[j] != 0;
        long long n = 0;
        int prev = -1;
        for (long long i = 0; i < L; ++i) {
            unsigned char qb = qp[i * step];
            if (rc) qb = COMP_TBL[qb];
            const int m = UPPER_TBL[tp[i]] == UPPER_TBL[qb];
            n += (m != prev);
            prev = m;
        }
        runs_per_mop[j] = n;
    }
}

static void fill_runs_shard(const unsigned char* pool,
                            long long j0, long long j1,
                            const long long* lens, const long long* qpos0,
                            const long long* tpos0, const unsigned char* rev,
                            const long long* dest_off,
                            unsigned char* new_ops, long long* new_lens) {
    // op codes match the reference enum (inc/paf.h:52-58): '='=3, 'X'=4
    for (long long j = j0; j < j1; ++j) {
        const long long L = lens[j];
        const unsigned char* tp = pool + tpos0[j];
        const unsigned char* qp = pool + qpos0[j];
        const long long step = rev[j] ? -1 : 1;
        const bool rc = rev[j] != 0;
        long long d = dest_off[j], run_len = 0;
        int prev = -1;
        for (long long i = 0; i < L; ++i) {
            unsigned char qb = qp[i * step];
            if (rc) qb = COMP_TBL[qb];
            const int m = UPPER_TBL[tp[i]] == UPPER_TBL[qb];
            if (m != prev && prev != -1) {
                new_ops[d] = prev ? 3 : 4;
                new_lens[d] = run_len;
                ++d;
                run_len = 0;
            }
            ++run_len;
            prev = m;
        }
        if (L > 0) {
            new_ops[d] = prev ? 3 : 4;
            new_lens[d] = run_len;
        }
    }
}

void encode_runs_per_mop(const unsigned char* pool, long long n_mops,
                         const long long* lens, const long long* qpos0,
                         const long long* tpos0, const unsigned char* rev,
                         long long* runs_per_mop, long long n_threads) {
    init_tables();
    if (n_threads <= 1 || n_mops < 1024) {
        count_runs_shard(pool, 0, n_mops, lens, qpos0, tpos0, rev,
                         runs_per_mop);
        return;
    }
    std::vector<long long> jb;
    mop_range_bounds(n_mops, lens, n_threads, jb);
    std::vector<std::thread> th;
    for (long long s = 0; s < n_threads; ++s) {
        th.emplace_back([&, s] {
            count_runs_shard(pool, jb[s], jb[s + 1], lens, qpos0, tpos0, rev,
                             runs_per_mop);
        });
    }
    for (auto& t : th) t.join();
}

void encode_runs_fill_cigar(const unsigned char* pool, long long n_mops,
                            const long long* lens, const long long* qpos0,
                            const long long* tpos0, const unsigned char* rev,
                            const long long* dest_off,
                            unsigned char* new_ops, long long* new_lens,
                            long long n_threads) {
    init_tables();
    if (n_threads <= 1 || n_mops < 1024) {
        fill_runs_shard(pool, 0, n_mops, lens, qpos0, tpos0, rev, dest_off,
                        new_ops, new_lens);
        return;
    }
    std::vector<long long> jb;
    mop_range_bounds(n_mops, lens, n_threads, jb);
    std::vector<std::thread> th;
    for (long long s = 0; s < n_threads; ++s) {
        th.emplace_back([&, s] {
            fill_runs_shard(pool, jb[s], jb[s + 1], lens, qpos0, tpos0, rev,
                            dest_off, new_ops, new_lens);
        });
    }
    for (auto& t : th) t.join();
}

// ------------------------------------------------------ batch preparation
// Host-side preparation of the device kernel metadata (the numpy versions
// in ops/segments.py / ops/tiled.py are the no-toolchain fallback).  These
// are single sequential passes — the work is a few ops per cigar op /
// chunk, far below memory bandwidth.

// Flatten the M ops of a record batch into the per-mop arrays of
// MColumnBatch (ops/segments.build_m_column_batch).  Outputs must be sized
// >= n_mops (+1 for col_off; n_records+1 for rec_col_off).  Returns n_cols.
long long build_mop_batch(long long n_records,
                          const unsigned char* ops, const long long* lens,
                          const long long* off, const unsigned char* strand,
                          const long long* qstart, const long long* qend,
                          const long long* tstart,
                          const long long* qpool_off,
                          const long long* tpool_off,
                          long long* mlens, long long* recs,
                          long long* qpos0, long long* tpos0,
                          unsigned char* rev, long long* col_off,
                          long long* rec_col_off, long long* flat_idx) {
    long long n_mops = 0, n_cols = 0;
    col_off[0] = 0;
    for (long long r = 0; r < n_records; ++r) {
        rec_col_off[r] = n_cols;
        long long q_excl = 0, t_excl = 0;
        const bool fwd = strand[r] != 0;
        for (long long k = off[r]; k < off[r + 1]; ++k) {
            const unsigned char op = ops[k];
            const long long L = lens[k];
            if (op == 0) {               // M
                mlens[n_mops] = L;
                recs[n_mops] = r;
                rev[n_mops] = fwd ? 0 : 1;
                qpos0[n_mops] = fwd ? qpool_off[r] + qstart[r] + q_excl
                                    : qpool_off[r] + qend[r] - 1 - q_excl;
                tpos0[n_mops] = tpool_off[r] + tstart[r] + t_excl;
                flat_idx[n_mops] = k;
                n_cols += L;
                col_off[++n_mops] = n_cols;
            }
            if (op != 2) q_excl += L;    // not D -> consumes query
            if (op != 1) t_excl += L;    // not I -> consumes target
        }
    }
    rec_col_off[n_records] = n_cols;
    return n_cols;
}

// Per-record alignment stats in one pass (paf_stats_calc,
// impl/paf.c:236-260).  out is [n_records, 7] int64:
//   matches (M and =), mismatches (X), query-insert events, query-delete
//   events, query-insert bases, query-delete bases, M-only bases (the
//   view pipeline's kernel-adjustment term).
void cigar_stats(long long n_records, const unsigned char* ops,
                 const long long* lens, const long long* off,
                 long long* out) {
    for (long long r = 0; r < n_records; ++r) {
        long long* o = out + r * 7;
        for (int c = 0; c < 7; ++c) o[c] = 0;
        for (long long k = off[r]; k < off[r + 1]; ++k) {
            const long long L = lens[k];
            switch (ops[k]) {
                case 0: o[0] += L; o[6] += L; break;   // M
                case 3: o[0] += L; break;              // =
                case 4: o[1] += L; break;              // X
                case 1: o[2] += 1; o[4] += L; break;   // I
                case 2: o[3] += 1; o[5] += L; break;   // D
            }
        }
    }
}

// Per-record alignment stats tokenized straight from the RAW cg:Z text
// kept by raw-cigar mode — same semantics and [n,7] layout as cigar_stats
// (paf_stats_calc, impl/paf.c:236-260), no op arrays built.  Text is
// assumed already accepted by paf_fill_raw's validate pass; cg_len==0
// records report zeros.
void cigar_stats_raw(long long n_records, const char* buf,
                     const long long* cg_start, const long long* cg_len,
                     long long* out, long long n_threads) {
    auto shard = [&](long long r0, long long r1) {
        for (long long r = r0; r < r1; ++r) {
            long long* o = out + r * 7;
            for (int c = 0; c < 7; ++c) o[c] = 0;
            const char* p = buf + cg_start[r];
            const char* e = p + cg_len[r];
            while (p < e) {
                long long L = 0;
                while (p < e && *p >= '0' && *p <= '9')
                    L = L * 10 + (*p++ - '0');
                if (p >= e) break;
                switch (*p++) {
                    case 'M': o[0] += L; o[6] += L; break;
                    case '=': o[0] += L; break;
                    case 'X': o[1] += L; break;
                    case 'I': o[2] += 1; o[4] += L; break;
                    case 'D': o[3] += 1; o[5] += L; break;
                }
            }
        }
    };
    if (n_threads <= 1 || n_records < 4096) {
        shard(0, n_records);
        return;
    }
    std::vector<std::thread> th;
    const long long step = (n_records + n_threads - 1) / n_threads;
    for (long long s = 0; s < n_threads; ++s) {
        const long long r0 = s * step;
        const long long r1 = std::min(n_records, r0 + step);
        if (r0 >= r1) break;
        th.emplace_back(shard, r0, r1);
    }
    for (auto& t : th) t.join();
}

// Chunk decomposition over the 2-bit packed pools
// (ops/tiled.build_packed2_chunk_batch; constants must match tiled.py:
// w2 = W2 row bytes, pack2_cols = 4*W2 columns per row).  Pass trow=NULL to
// count chunks only.  Returns the chunk count.
long long build_packed2_grid(long long n_mops, const long long* lens,
                             const long long* qpos0, const long long* tpos0,
                             const unsigned char* rev, const long long* recs,
                             long long n_records, long long pool_len,
                             long long w2,
                             int* trow, int* qwin, signed char* qpar,
                             short* col_a, short* col_b,
                             int* rec_chunk_off) {
    const long long pack2_cols = 4 * w2;
    const long long rp = (2 * pool_len) / 4 / w2;   // rows per parity pool
    int logw2 = 0;
    while ((1LL << logw2) < w2) ++logw2;
    long long u = 0, cur_rec = 0;
    for (long long j = 0; j < n_mops; ++j) {
        const long long L = lens[j];
        const long long tp = tpos0[j];
        const long long tpar = tp & 3;
        const long long base_t = (tp - tpar) >> 2;
        const long long row_lo = base_t >> logw2;
        // arithmetic shifts to match the numpy version's floor semantics
        // (L=0 makes the numerator -1; C division would truncate to 0)
        const long long row_hi = (base_t + ((L - 1) >> 2)) >> logw2;
        if (!trow) { u += row_hi - row_lo + 1; continue; }
        while (cur_rec <= recs[j]) rec_chunk_off[cur_rec++] = (int)u;
        const long long qe = rev[j] ? 2 * pool_len - 1 - qpos0[j] : qpos0[j];
        for (long long prow = row_lo; prow <= row_hi; ++prow, ++u) {
            const long long c_base = 4 * (prow * w2 - base_t);
            long long ca = -c_base; if (ca < 0) ca = 0;
            long long cbv = L - c_base;
            if (cbv < 0) cbv = 0; else if (cbv > pack2_cols) cbv = pack2_cols;
            col_a[u] = (short)ca;          // <= 4*w2, fits int16
            col_b[u] = (short)cbv;
            trow[u] = (int)(tpar * rp + prow);
            const long long qj = qe + c_base;
            const long long qp = qj & 3;
            long long qw = (qj - qp) >> 2; if (qw < 0) qw = 0;
            qpar[u] = (signed char)qp;     // 0..3
            qwin[u] = (int)qw;
        }
    }
    if (trow) {
        while (cur_rec <= n_records) rec_chunk_off[cur_rec++] = (int)u;
    }
    return u;
}

// --------------------------------------- fused mismatch-encode + serialize
// add_mismatches end-to-end in two threaded passes: walk each record's
// cigar, compare query/target bases over M runs (paf_encode_mismatches,
// impl/paf.c:739-784) and emit the output PAF LINE TEXT directly — no
// intermediate =/X op arrays (a 16x-golden run materialized ~1 GB of CSR
// ints), no separate serializer passes.  Phase 1 measures each line's
// exact byte length; caller prefix-sums; phase 2 writes at exact offsets.
// The per-record walk mirrors the reference exactly: query walks forward
// from query_start on '+', backward from query_end-1 with complement on
// '-'; target always forward from target_start; =/X runs never merge
// across original op boundaries.

}  // extern "C" (template helpers need C++ linkage)

template <bool WRITE>
static inline long long encode_cigar_walk(long long i, const long long* ints,
                                          const unsigned char* flags,
                                          const unsigned char* ops,
                                          const long long* op_lens,
                                          const long long* cig_off,
                                          const unsigned char* pool,
                                          const long long* qpool_off,
                                          const long long* tpool_off,
                                          char* out) {
    static const char opch[5] = {'M', 'I', 'D', '=', 'X'};
    const long long* R = ints + i * 13;
    const unsigned char* q = pool + qpool_off[i];
    const unsigned char* t = pool + tpool_off[i];
    const bool fwd = (flags[i] & 1) != 0;
    long long qi = 0, tj = R[4];   // R[4] = target_start
    long long n = 0;
    char* b = out;
    for (long long k = cig_off[i]; k < cig_off[i + 1]; ++k) {
        const unsigned char op = ops[k];
        const long long L = op_lens[k];
        if (op == 0) {             // M: compare and emit =/X runs
            const unsigned char* tp = t + tj;
            int prev;
            long long run = 1, c = 1;
            // direction-specialized compare loops (the step multiply +
            // complement branch per column measured as real cost); the
            // reverse loop folds upper(comp(x)) into one table
            if (fwd) {
                const unsigned char* qp = q + R[1] + qi;   // query_start
                prev = UPPER_TBL[tp[0]] == UPPER_TBL[qp[0]];
                for (; c < L; ++c) {
                    const int m = UPPER_TBL[tp[c]] == UPPER_TBL[qp[c]];
                    if (m != prev) {
                        if (WRITE) {
                            b = write_i64(b, run);
                            *b++ = prev ? '=' : 'X';
                        } else {
                            n += i64_digits(run) + 1;
                        }
                        run = 0;
                        prev = m;
                    }
                    ++run;
                }
            } else {
                const unsigned char* qp = q + R[2] - 1 - qi; // query_end-1
                prev = UPPER_TBL[tp[0]] == UPPER_COMP_TBL[qp[0]];
                for (; c < L; ++c) {
                    const int m = UPPER_TBL[tp[c]] == UPPER_COMP_TBL[qp[-c]];
                    if (m != prev) {
                        if (WRITE) {
                            b = write_i64(b, run);
                            *b++ = prev ? '=' : 'X';
                        } else {
                            n += i64_digits(run) + 1;
                        }
                        run = 0;
                        prev = m;
                    }
                    ++run;
                }
            }
            if (L > 0) {
                if (WRITE) {
                    b = write_i64(b, run);
                    *b++ = prev ? '=' : 'X';
                } else {
                    n += i64_digits(run) + 1;
                }
            }
            qi += L; tj += L;
        } else {
            if (WRITE) {
                b = write_i64(b, L);
                *b++ = opch[op];
            } else {
                n += i64_digits(L) + 1;
            }
            if (op == 1) qi += L;          // query_insert
            else if (op == 2) tj += L;     // query_delete
            else { qi += L; tj += L; }     // =/X pass-through consume both
        }
    }
    return WRITE ? (b - out) : n;
}

// Column-balanced record range bounds: weight = ops + query span (a proxy
// for compare columns; exact balance needs a columns pass of its own).
static void encode_rec_bounds(long long n_records, const long long* ints,
                              const long long* cig_off, long long n_threads,
                              std::vector<long long>& rb) {
    rb.assign(n_threads + 1, n_records);
    rb[0] = 0;
    if (n_threads <= 1) return;
    double total = 0;
    for (long long i = 0; i < n_records; ++i)
        total += (double)(cig_off[i + 1] - cig_off[i])
               + (double)(ints[i * 13 + 2] - ints[i * 13 + 1]);
    double acc = 0;
    long long i = 0;
    for (long long s = 1; s < n_threads; ++s) {
        const double target = total * (double)s / (double)n_threads;
        while (i < n_records && acc < target) {
            acc += (double)(cig_off[i + 1] - cig_off[i])
                 + (double)(ints[i * 13 + 2] - ints[i * 13 + 1]);
            ++i;
        }
        rb[s] = i;
    }
}

// ------------------------------------------- fused invert + serialize
// paffy invert over a RAW-cigar table: fields are emitted query/target-
// swapped (paf_invert, impl/paf.c:463-490) and the cigar TEXT is
// transformed in place of a parse: I<->D op swap, token order reversed
// for opposite-strand records.  The transform preserves byte length
// (digits unchanged), so the sizes pass never touches cigar text.  The
// fill pass accumulates query/target spans while tokenizing and reports
// the first record whose spans disagree with its (inverted) coordinates —
// the paf_check the reference runs after inverting (impl/paf_invert.c:86);
// bounds checks run vectorized in Python on the raw table.
// ints here is the ALREADY-SWAPPED [n,13] matrix (caller swaps columns and
// name offsets); cg spans are checked against R[1..2]/R[4..5] as written.

static inline long long invert_cig_emit(char* b, const char* src,
                                        long long len, bool reverse,
                                        long long* qspan, long long* tspan) {
    // forward: copy with I<->D swap; reverse: emit tokens back-to-front.
    // Returns bytes written (== len) or -1 on malformed text (the raw
    // validator normally rejects these first).
    long long q = 0, t = 0;
    if (!reverse) {
        const char* p = src;
        const char* e = src + len;
        char* o = b;
        while (p < e) {
            long long v = 0;
            const char* d0 = p;
            while (p < e && *p >= '0' && *p <= '9') {
                v = v * 10 + (*p - '0');
                ++p;
            }
            if (p == d0 || p == e) return -1;
            memcpy(o, d0, p - d0);
            o += p - d0;
            char op = *p++;
            // swapped roles: output op I consumes output-query etc.
            if (op == 'I') op = 'D';
            else if (op == 'D') op = 'I';
            else if (op != 'M' && op != 'X' && op != '=') return -1;
            *o++ = op;
            if (op != 'D') q += v;       // output-query consumption
            if (op != 'I') t += v;
        }
        *qspan = q; *tspan = t;
        return o - b;
    }
    const char* start = src;
    const char* p = src + len;
    char* o = b;
    while (p > start) {
        char op = p[-1];
        if (op == 'I') op = 'D';
        else if (op == 'D') op = 'I';
        else if (op != 'M' && op != 'X' && op != '=') return -1;
        const char* de = p - 1;
        const char* d0 = de;
        long long v = 0;
        while (d0 > start && d0[-1] >= '0' && d0[-1] <= '9') --d0;
        if (d0 == de) return -1;
        for (const char* c = d0; c < de; ++c) v = v * 10 + (*c - '0');
        memcpy(o, d0, de - d0);
        o += de - d0;
        *o++ = op;
        if (op != 'D') q += v;
        if (op != 'I') t += v;
        p = d0;
    }
    *qspan = q; *tspan = t;
    return o - b;
}

extern "C" long long invert_serialize_fill(long long n_records,
                                           const long long* ints,
                                           const unsigned char* flags,
                                           const unsigned char* type,
                                           const long long* qname_off,
                                           const long long* tname_off,
                                           const char* name_pool,
                                           const char* raw_buf,
                                           const long long* cg_start,
                                           const long long* cg_len,
                                           const long long* out_off,
                                           char* out, long long n_threads) {
    std::atomic<long long> bad{0};       // drift/malformed
    std::atomic<long long> span_bad{-1}; // first span-mismatch record
    auto work = [&](long long r0, long long r1) {
        for (long long i = r0; i < r1; ++i) {
            char* b = out + out_off[i];
            b = write_record_prefix(b, i, ints, flags, type, qname_off,
                                    tname_off, name_pool);
            if (flags[i] & 2) {
                memcpy(b, "\tcg:Z:", 6); b += 6;
                long long q = 0, t = 0;
                const long long w = invert_cig_emit(
                    b, raw_buf + cg_start[i], cg_len[i],
                    (flags[i] & 1) == 0, &q, &t);
                if (w < 0) { bad = 1; continue; }
                b += w;
                const long long* R = ints + i * 13;
                if (q != R[2] - R[1] || t != R[5] - R[4]) {
                    long long cur = span_bad.load();
                    while ((cur == -1 || i < cur)
                           && !span_bad.compare_exchange_weak(cur, i)) {}
                }
            }
            *b++ = '\n';
            if (b - (out + out_off[i]) != out_off[i + 1] - out_off[i])
                bad = 1;
        }
    };
    if (n_threads <= 1 || n_records < 4096) {
        work(0, n_records);
    } else {
        std::vector<std::thread> th;
        for (long long s = 0; s < n_threads; ++s)
            th.emplace_back(work, n_records * s / n_threads,
                            n_records * (s + 1) / n_threads);
        for (auto& t : th) t.join();
    }
    if (bad.load()) return -2;
    return span_bad.load();   // -1 = ok, else first bad record
}

// ------------------------------------------ fused shatter + serialize
// paffy shatter end-to-end: walk each record's cigar (paf_shatter,
// impl/paf.c:600-663 — query starts at query_start on '+' / query_end on
// '-' and walks backward; target forward from target_start) and emit each
// M run's single-op gapless output LINE directly — no intermediate
// 2.9M-record table, no [N,13] ints matrix, no separate serializer passes.
// Shattered records inherit score/mapq/tile_level/type/chain_id and get
// chain_score=0 (the calloc'd default in paf_shatter2) -> "\ts1:i:0" is
// always emitted; cigar is "{L}M".

template <bool WRITE>
static inline long long shatter_walk_rec(long long i, const long long* ints,
                                         const unsigned char* flags,
                                         const unsigned char* type,
                                         const long long* qname_off,
                                         const long long* tname_off,
                                         const char* name_pool,
                                         const unsigned char* ops,
                                         const long long* op_lens,
                                         const long long* cig_off,
                                         char* out) {
    const long long* R = ints + i * 13;
    const char* qn = name_pool + qname_off[i];
    const char* tn = name_pool + tname_off[i];
    const size_t qnl = strlen(qn), tnl = strlen(tn);
    const bool fwd = (flags[i] & 1) != 0;
    // per-record constant bytes of each output line (fields 0,1,4,5,6,11,
    // the 11 field tabs, the tag block incl. s1:i:0, "\tcg:Z:", "M\n")
    long long fixed = (long long)qnl + (long long)tnl + 1 + 11
                    + i64_digits(R[0]) + i64_digits(R[3])
                    + i64_digits(R[8]) + 7 /* \ts1:i:0 */
                    + 6 /* \tcg:Z: */ + 2 /* M\n */;
    if (type[i] != 0 || R[10] != -1) fixed += 7;
    if (R[9] != 2147483647LL) fixed += 6 + i64_digits(R[9]);
    if (R[10] != -1) fixed += 6 + i64_digits(R[10]);
    if (R[11] != -1) fixed += 6 + i64_digits(R[11]);
    long long q = fwd ? R[1] : R[2];    // query_start / query_end
    long long t = R[4];                 // target_start
    long long n = 0;
    char* b = out;
    for (long long k = cig_off[i]; k < cig_off[i + 1]; ++k) {
        const unsigned char op = ops[k];
        const long long L = op_lens[k];
        if (op == 0) {
            if (!fwd) q -= L;
            if (WRITE) {
                memcpy(b, qn, qnl); b += qnl; *b++ = '\t';
                b = write_i64(b, R[0]); *b++ = '\t';
                b = write_i64(b, q); *b++ = '\t';
                b = write_i64(b, q + L); *b++ = '\t';
                *b++ = fwd ? '+' : '-'; *b++ = '\t';
                memcpy(b, tn, tnl); b += tnl; *b++ = '\t';
                b = write_i64(b, R[3]); *b++ = '\t';
                b = write_i64(b, t); *b++ = '\t';
                b = write_i64(b, t + L); *b++ = '\t';
                b = write_i64(b, L); *b++ = '\t';
                b = write_i64(b, L); *b++ = '\t';
                b = write_i64(b, R[8]);
                if (type[i] != 0 || R[10] != -1) {
                    char c = type[i] ? (char)type[i]
                                     : (R[10] > 1 ? 'S' : 'P');
                    memcpy(b, "\ttp:A:", 6); b += 6; *b++ = c;
                }
                if (R[9] != 2147483647LL) {
                    memcpy(b, "\tAS:i:", 6); b += 6;
                    b = write_i64(b, R[9]);
                }
                if (R[10] != -1) {
                    memcpy(b, "\ttl:i:", 6); b += 6;
                    b = write_i64(b, R[10]);
                }
                if (R[11] != -1) {
                    memcpy(b, "\tcn:i:", 6); b += 6;
                    b = write_i64(b, R[11]);
                }
                memcpy(b, "\ts1:i:0", 7); b += 7;
                memcpy(b, "\tcg:Z:", 6); b += 6;
                b = write_i64(b, L);
                *b++ = 'M'; *b++ = '\n';
            } else {
                const long long dL = i64_digits(L);
                n += fixed + i64_digits(q) + i64_digits(q + L)
                   + i64_digits(t) + i64_digits(t + L) + 3 * dL;
            }
            if (fwd) q += L;
            t += L;
        } else if (op == 1) {           // query_insert
            q += fwd ? L : -L;
        } else {                        // query_delete
            t += L;
        }
    }
    return WRITE ? (b - out) : n;
}

extern "C" void shatter_serialize_sizes(long long n_records,
                                        const long long* ints,
                                        const unsigned char* flags,
                                        const unsigned char* type,
                                        const long long* qname_off,
                                        const long long* tname_off,
                                        const char* name_pool,
                                        const unsigned char* ops,
                                        const long long* op_lens,
                                        const long long* cig_off,
                                        long long* sizes,
                                        long long n_threads) {
    std::vector<long long> rb;
    encode_rec_bounds(n_records, ints, cig_off, n_threads, rb);
    auto work = [&](long long r0, long long r1) {
        for (long long i = r0; i < r1; ++i)
            sizes[i] = shatter_walk_rec<false>(
                i, ints, flags, type, qname_off, tname_off, name_pool,
                ops, op_lens, cig_off, nullptr);
    };
    if (n_threads <= 1) { work(0, n_records); return; }
    std::vector<std::thread> th;
    for (long long s = 0; s < n_threads; ++s)
        th.emplace_back(work, rb[s], rb[s + 1]);
    for (auto& t : th) t.join();
}

extern "C" long long shatter_serialize_fill(long long n_records,
                                            const long long* ints,
                                            const unsigned char* flags,
                                            const unsigned char* type,
                                            const long long* qname_off,
                                            const long long* tname_off,
                                            const char* name_pool,
                                            const unsigned char* ops,
                                            const long long* op_lens,
                                            const long long* cig_off,
                                            const long long* out_off,
                                            char* out, long long n_threads) {
    std::vector<long long> rb;
    encode_rec_bounds(n_records, ints, cig_off, n_threads, rb);
    std::atomic<long long> bad{0};
    auto work = [&](long long r0, long long r1) {
        for (long long i = r0; i < r1; ++i) {
            long long w = shatter_walk_rec<true>(
                i, ints, flags, type, qname_off, tname_off, name_pool,
                ops, op_lens, cig_off, out + out_off[i]);
            if (w != out_off[i + 1] - out_off[i]) bad = 1;
        }
    };
    if (n_threads <= 1) {
        work(0, n_records);
        return bad.load();
    }
    std::vector<std::thread> th;
    for (long long s = 0; s < n_threads; ++s)
        th.emplace_back(work, rb[s], rb[s + 1]);
    for (auto& t : th) t.join();
    return bad.load();
}


extern "C" {

void encode_serialize_sizes(long long n_records,
                            const long long* ints,
                            const unsigned char* flags,
                            const unsigned char* type,
                            const long long* qname_off,
                            const long long* tname_off,
                            const char* name_pool,
                            const unsigned char* ops,
                            const long long* op_lens,
                            const long long* cig_off,
                            const unsigned char* pool,
                            const long long* qpool_off,
                            const long long* tpool_off,
                            long long* sizes, long long n_threads) {
    init_tables();
    std::vector<long long> rb;
    encode_rec_bounds(n_records, ints, cig_off, n_threads, rb);
    auto work = [&](long long r0, long long r1) {
        for (long long i = r0; i < r1; ++i) {
            long long n = record_prefix_len(i, ints, flags, type, qname_off,
                                            tname_off, name_pool);
            if (flags[i] & 2)
                n += 6 + encode_cigar_walk<false>(
                    i, ints, flags, ops, op_lens, cig_off, pool,
                    qpool_off, tpool_off, nullptr);
            sizes[i] = n;
        }
    };
    if (n_threads <= 1) { work(0, n_records); return; }
    std::vector<std::thread> th;
    for (long long s = 0; s < n_threads; ++s)
        th.emplace_back(work, rb[s], rb[s + 1]);
    for (auto& t : th) t.join();
}

long long encode_serialize_fill(long long n_records,
                                const long long* ints,
                                const unsigned char* flags,
                                const unsigned char* type,
                                const long long* qname_off,
                                const long long* tname_off,
                                const char* name_pool,
                                const unsigned char* ops,
                                const long long* op_lens,
                                const long long* cig_off,
                                const unsigned char* pool,
                                const long long* qpool_off,
                                const long long* tpool_off,
                                const long long* out_off,
                                char* out, long long n_threads) {
    init_tables();
    std::vector<long long> rb;
    encode_rec_bounds(n_records, ints, cig_off, n_threads, rb);
    std::atomic<long long> bad{0};
    auto work = [&](long long r0, long long r1) {
        for (long long i = r0; i < r1; ++i) {
            char* b = out + out_off[i];
            b = write_record_prefix(b, i, ints, flags, type, qname_off,
                                    tname_off, name_pool);
            if (flags[i] & 2) {
                memcpy(b, "\tcg:Z:", 6); b += 6;
                b += encode_cigar_walk<true>(
                    i, ints, flags, ops, op_lens, cig_off, pool,
                    qpool_off, tpool_off, b);
            }
            *b++ = '\n';
            if (b - (out + out_off[i]) != out_off[i + 1] - out_off[i])
                bad = 1;
        }
    };
    if (n_threads <= 1) {
        work(0, n_records);
        return bad.load();
    }
    std::vector<std::thread> th;
    for (long long s = 0; s < n_threads; ++s)
        th.emplace_back(work, rb[s], rb[s + 1]);
    for (auto& t : th) t.join();
    return bad.load();
}

}  // extern "C"
