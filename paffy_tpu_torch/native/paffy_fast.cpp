// paffy_fast: the native lane of the port's host-only paffy commands
// (dedupe, split_file, invert, filter, trim, dechunk and shatter), a copy of
// paffy_tpu/native/paffy_fast.cpp.  Cactus runs these commands on every
// chunk file of a whole-genome alignment, and most such files are small, so
// the start-up of the Python lane (the interpreter, numpy and the port's
// modules) is their whole wall; this binary starts in milliseconds.
//
// bin/paffy-torch (a /bin/sh dispatcher) execs this binary for those seven
// commands when it exists and is newer than its sources; everything unusual
// (-h, unknown flags, debug logging, PAFFY_TPU_PROFILE, PAFFY_TPU_NO_FAST,
// inputs above PAFFY_TPU_FAST_MAX_BYTES, non-canonical cigars) re-execs the
// port's Python lane, bin/paffy-torch-py, which is the implementation of
// record and gives the same bytes.  chain is not served here: its DP is the
// K6 kernel on the card (ops/chain.py), so main() re-execs the Python lane
// for it as for any command this binary does not model.  The binary is built
// by paffy_tpu_torch/native/build_fast() into paffy_tpu_torch/_build/, on
// the Python lane's first use of the native library.
//
// It reuses the columnar passes of paffy_io.cpp (linked into the same
// executable): strtok-semantics tokenizing (tab collapse, sub-12-token
// lines = the reference's SIGSEGV class), raw-cigar fill (cg text re-emitted
// verbatim), the exact-size two-phase serializer (tag rules of
// impl/paf.c:343-389) and the invert, trim and shatter serializers.
//
// Error-path fidelity: output is staged and released with glibc-stdio
// granularity, so on a SIGSEGV-class input error (blank / sub-12-token line)
// exactly the full 4096-byte blocks the reference's stdio had already
// flushed reach the file, and on an errAbort-class error (bad strand/tp
// char, paf_check failure) the full prefix is flushed (exit() flushes stdio;
// abort()/SIGSEGV loses the buffer tail), as commands/common.GlibcWriter
// does on the Python lane.

#include <cstdarg>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <climits>
#include <string>
#include <string_view>
#include <vector>
#include <algorithm>
#include <unordered_map>
#include <unordered_set>
#include <thread>
#include <getopt.h>
#include <unistd.h>
#include <fcntl.h>
#include <sys/mman.h>
#include <errno.h>

// ---- columnar passes from paffy_io.cpp (compiled into this executable)
extern "C" {
void paf_serialize_sizes(long long n_records,
                         const long long* ints, const unsigned char* flags,
                         const unsigned char* type,
                         const long long* qname_off,
                         const long long* tname_off,
                         const char* name_pool,
                         const unsigned char* ops, const long long* op_lens,
                         const long long* cig_off, const long long* order,
                         const long long* cg_len,
                         long long* sizes, long long n_threads);
long long paf_serialize_fill(long long n_records,
                             const long long* ints,
                             const unsigned char* flags,
                             const unsigned char* type,
                             const long long* qname_off,
                             const long long* tname_off,
                             const char* name_pool,
                             const unsigned char* ops,
                             const long long* op_lens,
                             const long long* cig_off,
                             const long long* order,
                             const char* raw_buf,
                             const long long* cg_start,
                             const long long* cg_len,
                             const long long* out_off,
                             char* out, long long n_threads);
long long paf_scan_mt(const char* buf, long long len, long long n_threads,
                      long long* bounds, long long* recs, long long* ops,
                      long long* names, long long* lines);
long long paf_fill_mt(const char* buf, long long len, long long n_threads,
                      const long long* bounds, const long long* rec_base,
                      const long long* op_base, const long long* name_base,
                      const long long* lines,
                      long long* ints, unsigned char* flags,
                      unsigned char* type,
                      long long* qname_off, long long* tname_off,
                      char* name_pool,
                      unsigned char* ops, long long* op_lens,
                      long long* cig_off);
long long paf_scan_raw_mt(const char* buf, long long len,
                          long long n_threads, long long* bounds,
                          long long* rec_cnt, long long* name_cnt,
                          long long* lines);
long long paf_fill_raw_mt(const char* buf, long long len,
                          long long n_threads,
                          const long long* bounds, const long long* rec_base,
                          const long long* name_base, const long long* lines,
                          long long* ints, unsigned char* flags,
                          unsigned char* type,
                          long long* qname_off, long long* tname_off,
                          char* name_pool,
                          long long* cg_start, long long* cg_len,
                          long long validate, long long* noncanon);
void cigar_stats_raw(long long n_records, const char* buf,
                     const long long* cg_start, const long long* cg_len,
                     long long* out, long long n_threads);
void trim_tails_raw(long long n_records, const char* buf,
                    const long long* cg_start, const long long* cg_len,
                    const unsigned char* strand,
                    float score_fraction, float max_fraction,
                    long long* cg_a, long long* cg_n,
                    long long* dq1, long long* dt1,
                    long long* dq2, long long* dt2,
                    long long n_threads);
long long invert_serialize_fill(long long n_records,
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
                                char* out, long long n_threads);
long long shatter_violation(long long n_records, const long long* off,
                            const unsigned char* ops, const long long* lens,
                            const unsigned char* strand,
                            const long long* qstart, const long long* qend,
                            const long long* qlen,
                            const long long* tstart, const long long* tend,
                            const long long* tlen, long long* kind_out);
void shatter_serialize_sizes(long long n_records,
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
                             long long n_threads);
long long shatter_serialize_fill(long long n_records,
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
                                 char* out, long long n_threads);
}

namespace {

int g_threads() {
    unsigned n = std::thread::hardware_concurrency();
    return n ? (int)n : 1;
}

bool g_log_info = false;
void log_info(const char* fmt, ...) {
    if (!g_log_info) return;
    va_list ap; va_start(ap, fmt);
    vfprintf(stderr, fmt, ap);
    va_end(ap);
    fputc('\n', stderr);
}

// Original process argv (subcommand mains see a shifted argv; the
// re-exec must rebuild the FULL command line including the subcommand)
int g_argc = 0;
char** g_argv = nullptr;

// Re-exec the Python lane for anything this binary does not model exactly
// (usage/help text, unknown-flag rc, debug logging, profiler traces).
[[noreturn]] void reexec_python_full(int argc, char** argv) {
    char exe[4096];
    ssize_t n = readlink("/proc/self/exe", exe, sizeof exe - 1);
    if (n <= 0) _exit(3);
    exe[n] = '\0';
    // <repo>/paffy_tpu_torch/_build/paffy_fast_<hash> -> <repo>/bin/paffy-torch-py
    std::string repo(exe);
    for (int up = 0; up < 3; ++up) {
        size_t s = repo.rfind('/');
        if (s == std::string::npos) _exit(3);
        repo.resize(s);
    }
    std::string launcher = repo + "/bin/paffy-torch-py";
    std::vector<char*> nargv;
    nargv.push_back((char*)"python3");
    nargv.push_back((char*)"-S");
    nargv.push_back((char*)launcher.c_str());
    for (int i = 1; i < argc; ++i) nargv.push_back(argv[i]);
    nargv.push_back(nullptr);
    // python3 -S, as bin/paffy-torch runs the Python lane: the launcher
    // restores site-packages itself
    execvp("python3", nargv.data());
    _exit(3);
}

// Subcommand mains call this with their SHIFTED argv — always re-exec
// with the original full command line.
[[noreturn]] void reexec_python(int, char**) {
    reexec_python_full(g_argc, g_argv);
}

// The fast lane holds the whole input (the Python lane streams in
// bounded batches): above this size the streaming lane wins on memory,
// so defer.  The reference's own memory profile varies per command
// (dedupe/chain hold everything; invert/trim/filter stream at O(1)).
long long fast_max_bytes() {
    const char* e = getenv("PAFFY_TPU_FAST_MAX_BYTES");
    return e ? atoll(e) : (1ll << 30);
}

// Defer to Python AFTER the input was already consumed: when it came
// from stdin, replay the buffered bytes to the child through a memfd
// dup2'd onto fd 0 (a plain re-exec would hand the child an empty pipe).
[[noreturn]] void defer_python(const char* input_path,
                               const std::vector<char>& buf) {
    if (!input_path) {
        int fd = (int)memfd_create("paffy_stdin", 0);
        if (fd >= 0) {
            size_t o = 0;
            while (o < buf.size()) {
                ssize_t w = write(fd, buf.data() + o, buf.size() - o);
                if (w <= 0) break;
                o += (size_t)w;
            }
            lseek(fd, 0, SEEK_SET);
            dup2(fd, 0);
        }
    }
    reexec_python_full(g_argc, g_argv);
}

// ------------------------------------------------------------------ input

bool read_all(const char* path, std::vector<char>& buf) {
    int fd = path ? open(path, O_RDONLY) : 0;
    if (fd < 0) return false;
    char tmp[1 << 20];
    ssize_t r;
    while ((r = read(fd, tmp, sizeof tmp)) > 0)
        buf.insert(buf.end(), tmp, tmp + r);
    if (path) close(fd);
    return r >= 0;
}

// ------------------------------------------------- stdio-faithful output

void write_fd(int fd, const char* p, size_t n) {
    while (n) {
        ssize_t w = write(fd, p, n);
        if (w < 0) { if (errno == EINTR) continue; _exit(1); }
        p += w; n -= (size_t)w;
    }
}

// The reference writes through glibc stdio (4096-byte block buffering on
// pipes and regular files): exit() flushes everything, abort()/SIGSEGV
// loses the partial tail block.  We stage output and release it with the
// class the reference's death would have had.
enum ErrClass { ERR_NONE = 0, ERR_ABORT = 1, ERR_SEGV = 2 };

void release(int fd, const std::vector<char>& bytes, ErrClass cls) {
    size_t n = bytes.size();
    if (cls == ERR_SEGV) n -= n % 4096;      // unflushed tail lost
    write_fd(fd, bytes.data(), n);
}

// Streaming form of `release` for commands whose output is produced in
// windows (shatter's ~20x expansion): full 4096-byte blocks reach the fd
// as they complete, the sub-block tail is held until the death class is
// known — byte-equivalent to staging everything, without the multi-GB
// buffer.
struct BlockWriter {
    int fd;
    char tail[4096];
    size_t tail_n = 0;

    explicit BlockWriter(int fd_) : fd(fd_) {}

    void write(const char* p, size_t n) {
        if (tail_n) {
            size_t take = std::min(n, sizeof tail - tail_n);
            memcpy(tail + tail_n, p, take);
            tail_n += take;
            p += take; n -= take;
            if (tail_n == sizeof tail) {
                write_fd(fd, tail, sizeof tail);
                tail_n = 0;
            } else {
                return;                       // n exhausted
            }
        }
        size_t cut = n - n % 4096;
        write_fd(fd, p, cut);
        memcpy(tail, p + cut, n - cut);
        tail_n = n - cut;
    }

    void finish(ErrClass cls) {
        if (cls != ERR_SEGV && tail_n) write_fd(fd, tail, tail_n);
        tail_n = 0;
    }
};

// --------------------------------------------------------- raw PAF table

struct RawTable {
    std::vector<char> buf;                   // input bytes (cg ranges point in)
    long long n = 0;
    std::vector<long long> ints;             // [n*13]
    std::vector<unsigned char> flags, type;
    std::vector<long long> qname_off, tname_off, cg_start, cg_len;
    std::vector<char> name_pool;
    ErrClass pending = ERR_NONE;             // parse error after record n-1

    const char* qname(long long i) const { return name_pool.data() + qname_off[i]; }
    const char* tname(long long i) const { return name_pool.data() + tname_off[i]; }
    long long* R(long long i) { return ints.data() + i * 13; }
    const long long* R(long long i) const { return ints.data() + i * 13; }
    bool strand(long long i) const { return flags[i] & 1; }
};

// byte offset of the start of 1-based line `line` (for truncating the
// parseable prefix ahead of a bad line)
size_t line_start_offset(const std::vector<char>& buf, long long line) {
    const char* p = buf.data();
    const char* end = p + buf.size();
    for (long long l = 1; l < line && p < end; ++l) {
        const char* nl = (const char*)memchr(p, '\n', end - p);
        if (!nl) return buf.size();
        p = nl + 1;
    }
    return (size_t)(p - buf.data());
}

// Parse the whole input with the reference read mode of these commands
// (parse_cigar=0, no cigar validation).  On a malformed line the records
// BEFORE it are kept and `pending` records the class the reference's death
// would have: blank / sub-12-strtok-token lines dereference strtok's NULL
// (SIGSEGV, buffer tail lost); >= 12-token semantic failures (strand / tp
// char) go through st_errAbort (exit flushes).  Classes match
// commands/common.stream_tables.
bool parse_raw(RawTable& t, long long validate = 0,
               long long* noncanon_out = nullptr) {
    long long len = (long long)t.buf.size();
    const long long T = std::max(1, g_threads());
    std::vector<long long> bounds(T + 1), recs(T, 0), names(T, 0),
        lines(T, 0);
    long long bad = paf_scan_raw_mt(t.buf.data(), len, T, bounds.data(),
                                    recs.data(), names.data(), lines.data());
    if (bad > 0) {
        t.pending = ERR_SEGV;
        len = (long long)line_start_offset(t.buf, bad);
        bad = paf_scan_raw_mt(t.buf.data(), len, T, bounds.data(),
                              recs.data(), names.data(), lines.data());
        if (bad > 0) return false;           // cannot happen: clean prefix
    }
    std::vector<long long> rec_base(T), name_base(T);
    long long n_records = 0, name_bytes = 0;
    for (long long s = 0; s < T; ++s) {
        rec_base[s] = n_records;
        name_base[s] = name_bytes;
        n_records += recs[s];
        name_bytes += names[s];
    }
    t.n = n_records;
    t.ints.resize(n_records * 13);
    t.flags.resize(n_records);
    t.type.resize(n_records);
    t.qname_off.resize(n_records);
    t.tname_off.resize(n_records);
    t.cg_start.resize(n_records);
    t.cg_len.resize(n_records);
    t.name_pool.resize(name_bytes ? name_bytes : 1);
    long long noncanon = 0;
    bad = paf_fill_raw_mt(t.buf.data(), len, T, bounds.data(),
                          rec_base.data(), name_base.data(), lines.data(),
                          t.ints.data(), t.flags.data(), t.type.data(),
                          t.qname_off.data(), t.tname_off.data(),
                          t.name_pool.data(), t.cg_start.data(),
                          t.cg_len.data(), validate, &noncanon);
    if (noncanon_out) *noncanon_out = noncanon;
    if (bad > 0) {
        // semantic failure at an earlier line wins over the scan's
        // structural failure (the reference dies at the first bad record)
        t.pending = ERR_ABORT;
        t.n = bad - 1;
    }
    return true;
}

// Full-parse table for the commands whose walks need op arrays (shatter).
struct FullTable {
    std::vector<char> buf;
    long long n = 0;
    std::vector<long long> ints;
    std::vector<unsigned char> flags, type;
    std::vector<long long> qname_off, tname_off;
    std::vector<char> name_pool;
    std::vector<unsigned char> ops;
    std::vector<long long> op_lens, cig_off;
    ErrClass pending = ERR_NONE;
    long long* R(long long i) { return ints.data() + i * 13; }
    bool strand(long long i) const { return flags[i] & 1; }
};

bool parse_full(FullTable& t) {
    long long len = (long long)t.buf.size();
    const long long T = std::max(1, g_threads());
    std::vector<long long> bounds(T + 1), recs(T, 0), opsc(T, 0),
        names(T, 0), lines(T, 0);
    long long bad = paf_scan_mt(t.buf.data(), len, T, bounds.data(),
                                recs.data(), opsc.data(), names.data(),
                                lines.data());
    if (bad > 0) {
        // scan rejects blank / sub-12-token lines (SIGSEGV class) AND bad
        // cigar characters (errAbort class) — classify by strtok token
        // count like commands/common._segv_class
        size_t off = line_start_offset(t.buf, bad);
        const char* p = t.buf.data() + off;
        const char* le = (const char*)memchr(p, '\n', t.buf.size() - off);
        if (!le) le = t.buf.data() + t.buf.size();
        int tokens = 0;
        for (const char* s = p; s < le; ) {
            while (s < le && *s == '\t') ++s;
            if (s >= le) break;
            ++tokens;
            while (s < le && *s != '\t') ++s;
        }
        t.pending = tokens < 12 ? ERR_SEGV : ERR_ABORT;
        len = (long long)off;
        bad = paf_scan_mt(t.buf.data(), len, T, bounds.data(), recs.data(),
                          opsc.data(), names.data(), lines.data());
        if (bad > 0) return false;           // cannot happen: clean prefix
    }
    std::vector<long long> rec_base(T), op_base(T), name_base(T);
    long long n_records = 0, n_ops = 0, name_bytes = 0;
    for (long long s = 0; s < T; ++s) {
        rec_base[s] = n_records;
        op_base[s] = n_ops;
        name_base[s] = name_bytes;
        n_records += recs[s];
        n_ops += opsc[s];
        name_bytes += names[s];
    }
    t.n = n_records;
    t.ints.resize(n_records * 13);
    t.flags.resize(n_records);
    t.type.resize(n_records);
    t.qname_off.resize(n_records);
    t.tname_off.resize(n_records);
    t.name_pool.resize(name_bytes ? name_bytes : 1);
    t.ops.resize(n_ops ? n_ops : 1);
    t.op_lens.resize(n_ops ? n_ops : 1);
    t.cig_off.resize(n_records + 1);
    bad = paf_fill_mt(t.buf.data(), len, T, bounds.data(), rec_base.data(),
                      op_base.data(), name_base.data(), lines.data(),
                      t.ints.data(), t.flags.data(), t.type.data(),
                      t.qname_off.data(), t.tname_off.data(),
                      t.name_pool.data(), t.ops.data(), t.op_lens.data(),
                      t.cig_off.data());
    if (bad > 0) {
        t.pending = ERR_ABORT;   // semantic failure (strand/tp), >= 12 tokens
        t.n = bad - 1;
    }
    return true;
}

// Serialize records order[0..m) (raw-cigar verbatim) into `out`.
void serialize(const RawTable& t, const std::vector<long long>& order,
               std::vector<char>& out) {
    long long m = (long long)order.size();
    if (!m) return;
    std::vector<long long> sizes(m), off(m + 1);
    paf_serialize_sizes(m, t.ints.data(), t.flags.data(), t.type.data(),
                        t.qname_off.data(), t.tname_off.data(),
                        t.name_pool.data(), nullptr, nullptr, nullptr,
                        order.data(), t.cg_len.data(), sizes.data(),
                        g_threads());
    off[0] = 0;
    for (long long r = 0; r < m; ++r) off[r + 1] = off[r] + sizes[r];
    out.resize(off[m]);
    paf_serialize_fill(m, t.ints.data(), t.flags.data(), t.type.data(),
                       t.qname_off.data(), t.tname_off.data(),
                       t.name_pool.data(), nullptr, nullptr, nullptr,
                       order.data(), t.buf.data(), t.cg_start.data(),
                       t.cg_len.data(), off.data(), out.data(), g_threads());
}

// paf_check on a raw record: coordinate classes only (the reference's
// cigar==NULL guard skips spans under its parse_cigar=0 reads,
// impl/paf.c:427-461).  Returns -1 ok, else the failing class 0-3.
int check_coords(const RawTable& t, long long i) {
    const long long* R = t.R(i);
    if (R[1] < 0 || R[1] >= R[0]) return 0;   // qstart
    if (R[1] > R[2] || R[2] > R[0]) return 1; // qend
    if (R[4] < 0 || R[4] >= R[3]) return 2;   // tstart
    if (R[4] > R[5] || R[5] > R[3]) return 3; // tend
    return -1;
}

const char* CHECK_MSG[6] = {
    "Paf query start coordinates are invalid",
    "Paf query end coordinates are invalid",
    "Paf target start coordinates are invalid",
    "Paf target end coordinates are invalid",
    "Paf cigar alignment does not match query length",
    "Paf cigar alignment does not match target length",
};

// [n,7] per-record cigar stats tokenized from the raw cg text
// (cigar_stats_raw layout: M+= cols, X cols, I ops, D ops, I bases,
// D bases, M cols)
std::vector<long long> raw_stats(const RawTable& t) {
    std::vector<long long> st(t.n * 7);
    if (t.n)
        cigar_stats_raw(t.n, t.buf.data(), t.cg_start.data(),
                        t.cg_len.data(), st.data(), g_threads());
    return st;
}

// Full paf_check of a raw record including the span checks the
// reference's parse_cigar=1 commands get (impl/paf.c:427-461): coords
// first, then query span, then target span.  st = raw_stats row base.
int check_full(const RawTable& t, long long i, const long long* st) {
    int code = check_coords(t, i);
    if (code >= 0) return code;
    if (!(t.flags[i] & 2)) return -1;
    const long long* R = t.R(i);
    const long long* o = st + i * 7;
    const long long aligned = o[0] + o[1];
    if (aligned + o[4] != R[2] - R[1]) return 4;
    if (aligned + o[5] != R[5] - R[4]) return 5;
    return -1;
}

// name interning: string_view keys point into the table's name pool
struct SvHash {
    size_t operator()(std::string_view s) const {
        return std::hash<std::string_view>()(s);
    }
};
using NameMap = std::unordered_map<std::string_view, uint32_t, SvHash>;

uint32_t intern(NameMap& m, const char* s) {
    auto [it, ins] = m.emplace(std::string_view(s), (uint32_t)m.size());
    return it->second;
}

// --------------------------------------------------------------- options

struct CommonOpts {
    const char* input = nullptr;
    const char* output = nullptr;
    bool bail = false;                       // defer to the Python lane
};

void set_log_level(const char* lvl, int argc, char** argv) {
    if (!lvl) return;
    std::string s(lvl);
    for (auto& c : s) c = (char)tolower((unsigned char)c);
    if (s == "debug")                        // debug output lives in Python
        reexec_python(argc, argv);
    if (s == "info") g_log_info = true;
    else if (s != "off" && s != "critical")  // unknown level: Python's error
        reexec_python(argc, argv);
}

long long parse_ll(const char* s, bool* ok) {
    char* end = nullptr;
    errno = 0;
    long long v = strtoll(s, &end, 10);
    *ok = end && *end == '\0' && end != s && errno == 0;
    return v;
}

// ----------------------------------------------------------------- dedupe

// paffy dedupe (impl/paf_dedupe.c:117-143): first-occurrence-wins on the
// full coordinate key; -a also probes the query/target-swapped key and
// paf_checks every record whose direct probe missed.
struct DedupeKey {
    uint32_t qid, tid;
    bool strand;
    long long qs, qe, ts, te;
    bool operator==(const DedupeKey& o) const {
        return qid == o.qid && tid == o.tid && strand == o.strand
            && qs == o.qs && qe == o.qe && ts == o.ts && te == o.te;
    }
};
struct DedupeKeyHash {
    size_t operator()(const DedupeKey& k) const {
        uint64_t h = 0x9e3779b97f4a7c15ULL ^ k.qid;
        auto mix = [&h](uint64_t v) {
            h ^= v + 0x9e3779b97f4a7c15ULL + (h << 6) + (h >> 2);
        };
        mix(k.tid); mix(k.strand); mix((uint64_t)k.qs); mix((uint64_t)k.qe);
        mix((uint64_t)k.ts); mix((uint64_t)k.te);
        return (size_t)h;
    }
};

int dedupe_main(int argc, char** argv) {
    static struct option lopts[] = {
        {"logLevel", required_argument, 0, 'l'},
        {"inputFile", required_argument, 0, 'i'},
        {"outputFile", required_argument, 0, 'o'},
        {"checkInverse", no_argument, 0, 'a'},
        {"help", no_argument, 0, 'h'},
        {0, 0, 0, 0}};
    CommonOpts c;
    bool check_inverse = false;
    const char* log_level = nullptr;
    opterr = 0;
    int key;
    while ((key = getopt_long(argc, argv, "l:i:o:ha", lopts, nullptr)) != -1) {
        switch (key) {
            case 'l': log_level = optarg; break;
            case 'i': c.input = optarg; break;
            case 'o': c.output = optarg; break;
            case 'a': check_inverse = true; break;
            default: reexec_python(argc, argv);
        }
    }
    if (optind < argc) reexec_python(argc, argv);  // stray positionals
    set_log_level(log_level, argc, argv);
    log_info("Input file string : %s", c.input ? c.input : "None");
    log_info("Output file string : %s", c.output ? c.output : "None");

    RawTable t;
    if (!read_all(c.input, t.buf) || !parse_raw(t)) {
        fprintf(stderr, "paffy dedupe: cannot read input: %s\n",
                c.input ? c.input : "<stdin>");
        return 1;
    }

    NameMap names;
    std::unordered_set<DedupeKey, DedupeKeyHash> seen;
    seen.reserve((size_t)t.n * 2);
    std::vector<long long> kept;
    kept.reserve(t.n);
    ErrClass err = t.pending;
    int bad_code = -1;
    long long bad_rec = -1;
    for (long long i = 0; i < t.n; ++i) {
        const long long* R = t.R(i);
        DedupeKey k{intern(names, t.qname(i)), intern(names, t.tname(i)),
                    t.strand(i), R[1], R[2], R[4], R[5]};
        if (seen.count(k)) continue;                  // direct duplicate
        bool dup = false;
        if (check_inverse) {
            // inverse probe first, then check — impl/paf_dedupe.c:120-124
            DedupeKey inv{k.tid, k.qid, k.strand, k.ts, k.te, k.qs, k.qe};
            dup = seen.count(inv) != 0;
            int code = check_coords(t, i);
            if (code >= 0) {                          // errAbort: flush prefix
                err = ERR_ABORT;
                bad_code = code;
                bad_rec = i;
                break;
            }
        }
        if (!dup) {
            seen.insert(k);
            kept.push_back(i);
        }
    }

    std::vector<char> out;
    serialize(t, kept, out);
    int fd = 1;
    if (c.output) {
        fd = open(c.output, O_WRONLY | O_CREAT | O_TRUNC, 0666);
        if (fd < 0) {
            fprintf(stderr, "paffy dedupe: cannot open output: %s\n", c.output);
            return 1;
        }
    }
    release(fd, out, err);
    if (c.output) close(fd);
    if (err != ERR_NONE) {
        if (bad_code >= 0)
            fprintf(stderr, "%s, record %lld\n", CHECK_MSG[bad_code], bad_rec);
        else
            fprintf(stderr, "paffy dedupe: malformed paf input\n");
        return 1;
    }
    log_info("Paffy dedupe is done!, 0 seconds have elapsed");
    return 0;
}

// ------------------------------------------------------------- split_file

// paffy split_file (impl/paf_split_file.c:128-170): demux records by target
// (default) or query contig; contigs shorter than minLength are first-fit-
// sequential bin-packed into <prefix>small_K.paf files.
int split_file_main(int argc, char** argv) {
    static struct option lopts[] = {
        {"logLevel", required_argument, 0, 'l'},
        {"inputFile", required_argument, 0, 'i'},
        {"prefix", required_argument, 0, 'p'},
        {"query", no_argument, 0, 'q'},
        {"minLength", required_argument, 0, 'm'},
        {"help", no_argument, 0, 'h'},
        {0, 0, 0, 0}};
    const char* input = nullptr;
    const char* prefix = "split_";
    bool by_query = false;
    long long min_length = 0;
    const char* log_level = nullptr;
    opterr = 0;
    int key;
    while ((key = getopt_long(argc, argv, "l:i:p:qm:h", lopts, nullptr)) != -1) {
        bool ok = true;
        switch (key) {
            case 'l': log_level = optarg; break;
            case 'i': input = optarg; break;
            case 'p': prefix = optarg; break;
            case 'q': by_query = true; break;
            case 'm': min_length = parse_ll(optarg, &ok);
                      if (!ok) reexec_python(argc, argv);
                      break;
            default: reexec_python(argc, argv);
        }
    }
    if (optind < argc) reexec_python(argc, argv);
    set_log_level(log_level, argc, argv);
    log_info("Input file string : %s", input ? input : "None");
    log_info("Output file string : %s", "None");

    RawTable t;
    if (!read_all(input, t.buf)) {
        fprintf(stderr, "paffy split_file: cannot read input: %s\n",
                input ? input : "<stdin>");
        return 1;
    }
    if ((long long)t.buf.size() > fast_max_bytes())
        defer_python(input, t.buf);
    if (!parse_raw(t)) {
        fprintf(stderr, "paffy split_file: cannot read input: %s\n",
                input ? input : "<stdin>");
        return 1;
    }

    struct OutFile { std::string path; int fd; std::vector<long long> recs; };
    std::vector<OutFile> files;
    NameMap contig_file;                       // contig name -> files index
    long long small_idx = 0, small_total = 0;
    int small_file = -1;                       // current small bin (files idx)
    ErrClass err = t.pending;
    bool open_failed = false;
    std::string failed_path;

    auto open_file = [&](std::string path) -> int {
        int fd = open(path.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0666);
        if (fd < 0) {
            open_failed = true;
            failed_path = path;
            return -1;
        }
        files.push_back(OutFile{std::move(path), fd, {}});
        return (int)files.size() - 1;
    };

    for (long long i = 0; i < t.n && !open_failed; ++i) {
        const char* nm = by_query ? t.qname(i) : t.tname(i);
        long long ln = by_query ? t.R(i)[0] : t.R(i)[3];
        auto it = contig_file.find(std::string_view(nm));
        int fidx;
        if (it != contig_file.end()) {
            fidx = (int)it->second;
        } else if (min_length > 0 && ln < min_length) {
            // first-fit-sequential packing (impl/paf_split_file.c:142-169)
            if (small_file < 0 || small_total + ln > min_length) {
                std::string path = std::string(prefix) + "small_"
                                 + std::to_string(small_idx++) + ".paf";
                log_info("Opened small contigs output file: %s", path.c_str());
                small_file = open_file(std::move(path));
                if (small_file < 0) break;
                small_total = 0;
            }
            small_total += ln;
            fidx = small_file;
            contig_file.emplace(std::string_view(nm), (uint32_t)fidx);
        } else {
            std::string path(prefix);
            for (const char* s = nm; *s; ++s)
                path += (*s == '/') ? '_' : *s;   // sanitize_filename
            path += ".paf";
            log_info("Opened output file: %s", path.c_str());
            fidx = open_file(std::move(path));
            if (fidx < 0) break;
            contig_file.emplace(std::string_view(nm), (uint32_t)fidx);
        }
        files[fidx].recs.push_back(i);
    }
    if (open_failed) err = ERR_ABORT;          // st_errAbort flushes

    // one serializer pass over all demuxed records, then per-file slices
    for (auto& f : files) {
        std::vector<char> bytes;
        serialize(t, f.recs, bytes);
        release(f.fd, bytes, err);
        close(f.fd);
    }
    if (open_failed) {
        fprintf(stderr, "Could not open output file: %s\n", failed_path.c_str());
        return 1;
    }
    if (err != ERR_NONE) {
        fprintf(stderr, "paffy split_file: malformed paf input\n");
        return 1;
    }
    log_info("Split %lld records", t.n);
    log_info("Paffy split_file is done!, 0 seconds have elapsed");
    return 0;
}

// Shared tail for the streaming-shaped commands: write the serialized
// bytes of `order` with the right death class, report, return rc.
int finish_stream(const RawTable& t, const std::vector<long long>& order,
                  const char* cmd, const char* out_path, ErrClass err,
                  const char* err_msg) {
    std::vector<char> out;
    serialize(t, order, out);
    int fd = 1;
    if (out_path) {
        fd = open(out_path, O_WRONLY | O_CREAT | O_TRUNC, 0666);
        if (fd < 0) {
            fprintf(stderr, "paffy %s: cannot open output: %s\n", cmd,
                    out_path);
            return 1;
        }
    }
    release(fd, out, err);
    if (out_path) close(fd);
    if (err != ERR_NONE) {
        fprintf(stderr, "paffy %s: %s\n", cmd,
                err_msg ? err_msg : "malformed paf input");
        return 1;
    }
    log_info("Paffy %s is done!, 0 seconds have elapsed", cmd);
    return 0;
}

// ------------------------------------------------------------------ invert

// paffy invert (impl/paf_invert.c:84-89): per record invert, paf_check,
// write.  The cigar transform (I<->D swap, token reversal on '-') runs in
// invert_serialize_fill straight over the raw cg bytes.
int invert_main(int argc, char** argv) {
    static struct option lopts[] = {
        {"logLevel", required_argument, 0, 'l'},
        {"inputFile", required_argument, 0, 'i'},
        {"outputFile", required_argument, 0, 'o'},
        {"help", no_argument, 0, 'h'},
        {0, 0, 0, 0}};
    CommonOpts c;
    const char* log_level = nullptr;
    opterr = 0;
    int key;
    while ((key = getopt_long(argc, argv, "l:i:o:h", lopts, nullptr)) != -1) {
        switch (key) {
            case 'l': log_level = optarg; break;
            case 'i': c.input = optarg; break;
            case 'o': c.output = optarg; break;
            default: reexec_python(argc, argv);
        }
    }
    if (optind < argc) reexec_python(argc, argv);
    set_log_level(log_level, argc, argv);
    log_info("Input file string : %s", c.input ? c.input : "None");
    log_info("Output file string : %s", c.output ? c.output : "None");

    RawTable t;
    long long noncanon = 0;
    if (!read_all(c.input, t.buf)) {
        fprintf(stderr, "paffy: cannot read input\n");
        return 1;
    }
    if ((long long)t.buf.size() > fast_max_bytes())
        defer_python(c.input, t.buf);   // streaming lane wins above this
    if (!parse_raw(t, 1, &noncanon)) {
        fprintf(stderr, "paffy invert: cannot read input\n");
        return 1;
    }
    if (noncanon) defer_python(c.input, t.buf);  // leading-zero lengths:
                                              // the full parser canonicalizes
    const long long n = t.n;
    // swap query/target columns + name roles IN PLACE
    // (paf_invert, impl/paf.c:463-490)
    for (long long i = 0; i < n; ++i) {
        long long* R = t.R(i);
        std::swap(R[0], R[3]);
        std::swap(R[1], R[4]);
        std::swap(R[2], R[5]);
    }
    std::swap(t.qname_off, t.tname_off);

    // serialize ALL records (sizes are cigar-transform-invariant: I<->D
    // swap / reversal preserves byte length), then find the first bad
    // record: coords and spans in per-record check order, earliest wins
    std::vector<long long> sizes(n), off(n + 1);
    off[0] = 0;
    if (n) {
        paf_serialize_sizes(n, t.ints.data(), t.flags.data(),
                            t.type.data(), t.qname_off.data(),
                            t.tname_off.data(), t.name_pool.data(),
                            nullptr, nullptr, nullptr, nullptr,
                            t.cg_len.data(), sizes.data(), g_threads());
        for (long long r = 0; r < n; ++r) off[r + 1] = off[r] + sizes[r];
    }
    std::vector<char> out(off[n]);
    long long span_bad = -1;
    if (n) {
        span_bad = invert_serialize_fill(
            n, t.ints.data(), t.flags.data(), t.type.data(),
            t.qname_off.data(), t.tname_off.data(), t.name_pool.data(),
            t.buf.data(), t.cg_start.data(), t.cg_len.data(),
            off.data(), out.data(), g_threads());
        if (span_bad == -2) defer_python(c.input, t.buf);  // malformed: defer
    }
    long long bad = -1;
    int code = -1;
    for (long long i = 0; i < n; ++i) {
        int cc = check_coords(t, i);
        if (cc >= 0) { bad = i; code = cc; break; }
        if (i == span_bad) break;   // span failure at this record wins next
    }
    if (span_bad >= 0 && (bad < 0 || span_bad < bad)) {
        bad = span_bad;
        // fill reports one span condition; q-axis checked first
        code = 4;
    }
    ErrClass err = t.pending;
    const char* msg = nullptr;
    if (bad >= 0) {
        err = ERR_ABORT;            // paf_check -> st_errAbort: flush
        msg = CHECK_MSG[code];
        out.resize(off[bad]);
    }
    int fd = 1;
    if (c.output) {
        fd = open(c.output, O_WRONLY | O_CREAT | O_TRUNC, 0666);
        if (fd < 0) {
            fprintf(stderr, "paffy invert: cannot open output: %s\n",
                    c.output);
            return 1;
        }
    }
    release(fd, out, err);
    if (c.output) close(fd);
    if (err != ERR_NONE) {
        fprintf(stderr, "paffy invert: %s\n",
                msg ? msg : "malformed paf input");
        return 1;
    }
    log_info("Paf invert is done!, 0 seconds have elapsed");
    return 0;
}

// ------------------------------------------------------------------ filter

// paffy filter (impl/paf_filter.c:123-155): per-record stats from the raw
// cg text, keep-condition with C float identity compares (NaN on
// cigarless records fails >= exactly as in the reference).
int filter_main(int argc, char** argv) {
    static struct option lopts[] = {
        {"logLevel", required_argument, 0, 'l'},
        {"inputFile", required_argument, 0, 'i'},
        {"outputFile", required_argument, 0, 'o'},
        {"minChainScore", required_argument, 0, 's'},
        {"minAlignmentScore", required_argument, 0, 't'},
        {"minIdentity", required_argument, 0, 'u'},
        {"minIdentityWithGaps", required_argument, 0, 'v'},
        {"maxTileLevel", required_argument, 0, 'w'},
        {"invert", no_argument, 0, 'x'},
        {"help", no_argument, 0, 'h'},
        {0, 0, 0, 0}};
    CommonOpts c;
    long long min_chain = -1, min_align = -1, max_tile = -1;
    double min_ident = -1.0, min_identg = -1.0;
    bool inv = false;
    const char* log_level = nullptr;
    opterr = 0;
    int key;
    bool ok = true;
    while ((key = getopt_long(argc, argv, "l:i:o:s:t:u:v:w:xh", lopts,
                              nullptr)) != -1) {
        switch (key) {
            case 'l': log_level = optarg; break;
            case 'i': c.input = optarg; break;
            case 'o': c.output = optarg; break;
            case 's': min_chain = parse_ll(optarg, &ok); break;
            case 't': min_align = parse_ll(optarg, &ok); break;
            case 'w': max_tile = parse_ll(optarg, &ok); break;
            case 'u': {
                char* e = nullptr;
                min_ident = strtod(optarg, &e);
                ok = e && *e == '\0' && e != optarg;
                break;
            }
            case 'v': {
                char* e = nullptr;
                min_identg = strtod(optarg, &e);
                ok = e && *e == '\0' && e != optarg;
                break;
            }
            case 'x': inv = true; break;
            default: reexec_python(argc, argv);
        }
        if (!ok) reexec_python(argc, argv);
    }
    if (optind < argc) reexec_python(argc, argv);
    set_log_level(log_level, argc, argv);
    log_info("Input file string : %s", c.input ? c.input : "None");
    log_info("Output file string : %s", c.output ? c.output : "None");

    RawTable t;
    long long noncanon = 0;
    if (!read_all(c.input, t.buf)) {
        fprintf(stderr, "paffy: cannot read input\n");
        return 1;
    }
    if ((long long)t.buf.size() > fast_max_bytes())
        defer_python(c.input, t.buf);   // streaming lane wins above this
    if (!parse_raw(t, 1, &noncanon)) {
        fprintf(stderr, "paffy filter: cannot read input\n");
        return 1;
    }
    if (noncanon) defer_python(c.input, t.buf);
    std::vector<long long> st = raw_stats(t);
    std::vector<long long> kept;
    kept.reserve(t.n);
    const float fu = (float)min_ident, fv = (float)min_identg;
    for (long long i = 0; i < t.n; ++i) {
        const long long* o = st.data() + i * 7;
        const long long m = o[0], x = o[1], qib = o[4], qdb = o[5];
        const float ident = (float)m / (float)(m + x);
        const float identg = (float)m / (float)(m + x + qib + qdb);
        const long long* R = t.R(i);
        const bool passes = R[9] >= min_align && R[12] >= min_chain
            && (max_tile == -1 || R[10] <= max_tile)
            && ident >= fu && identg >= fv;
        if (inv ? !passes : passes) kept.push_back(i);
    }
    return finish_stream(t, kept, "filter", c.output, t.pending, nullptr);
}

// -------------------------------------------------------------------- trim

// paffy trim (impl/paf_trim.c:116-126, identity mode): the kept cigar is a
// contiguous substring of the raw cg text (trim_tails_raw), coordinates
// shift by the consumed deltas, then per-record paf_check with spans.
int trim_main(int argc, char** argv) {
    static struct option lopts[] = {
        {"logLevel", required_argument, 0, 'l'},
        {"inputFile", required_argument, 0, 'i'},
        {"outputFile", required_argument, 0, 'o'},
        {"trimIdentity", required_argument, 0, 'r'},
        {"trimFraction", required_argument, 0, 't'},
        {"fixedTrim", no_argument, 0, 'f'},
        {"help", no_argument, 0, 'h'},
        {0, 0, 0, 0}};
    CommonOpts c;
    double trim_ident = 0.05, trim_frac = 1.0;
    const char* log_level = nullptr;
    opterr = 0;
    int key;
    bool ok = true;
    while ((key = getopt_long(argc, argv, "l:i:o:r:t:fh", lopts, nullptr))
           != -1) {
        switch (key) {
            case 'l': log_level = optarg; break;
            case 'i': c.input = optarg; break;
            case 'o': c.output = optarg; break;
            case 'r': {
                char* e = nullptr;
                trim_ident = strtod(optarg, &e);
                ok = e && *e == '\0' && e != optarg;
                break;
            }
            case 't': {
                char* e = nullptr;
                trim_frac = strtod(optarg, &e);
                ok = e && *e == '\0' && e != optarg;
                break;
            }
            case 'f': reexec_python(argc, argv);  // fixed trim: parsed path
            default: reexec_python(argc, argv);
        }
        if (!ok) reexec_python(argc, argv);
    }
    if (optind < argc) reexec_python(argc, argv);
    set_log_level(log_level, argc, argv);
    log_info("Input file string : %s", c.input ? c.input : "None");
    log_info("Output file string : %s", c.output ? c.output : "None");

    RawTable t;
    long long noncanon = 0;
    if (!read_all(c.input, t.buf)) {
        fprintf(stderr, "paffy: cannot read input\n");
        return 1;
    }
    if ((long long)t.buf.size() > fast_max_bytes())
        defer_python(c.input, t.buf);   // streaming lane wins above this
    if (!parse_raw(t, 1, &noncanon)) {
        fprintf(stderr, "paffy trim: cannot read input\n");
        return 1;
    }
    if (noncanon) defer_python(c.input, t.buf);
    const long long n = t.n;
    if (n) {
        std::vector<unsigned char> strand(n);
        for (long long i = 0; i < n; ++i) strand[i] = t.flags[i] & 1;
        std::vector<long long> cg_a(n), cg_n(n), dq1(n), dt1(n), dq2(n),
            dt2(n);
        trim_tails_raw(n, t.buf.data(), t.cg_start.data(), t.cg_len.data(),
                       strand.data(), (float)trim_ident, (float)trim_frac,
                       cg_a.data(), cg_n.data(), dq1.data(), dt1.data(),
                       dq2.data(), dt2.data(), g_threads());
        // coordinate application (ops/tailtrim.py raw path): pass 1 trims
        // the front (query from qstart '+' / qend '-'), pass 2 the
        // inverted frame
        for (long long i = 0; i < n; ++i) {
            long long* R = t.R(i);
            const bool s = strand[i];
            R[1] += (s ? dq1[i] : 0) + dq2[i];
            R[2] -= s ? 0 : dq1[i];
            R[4] += dt1[i] + (s ? dt2[i] : 0);
            R[5] -= s ? 0 : dt2[i];
            t.cg_start[i] = cg_a[i];
            t.cg_len[i] = cg_n[i];
            if (cg_n[i] == 0) t.flags[i] &= ~2;  // fully trimmed away
        }
    }
    // paf_check with raw spans, record-at-a-time order; the identity-trim
    // NaN sanity assert (OP-FREE cigar -> 0/0 identity — indels count as
    // mismatches there, so all-I/all-D survive; impl/paf.c:818-828,952)
    // fires BEFORE the record's own check and dies SIGABRT-class
    // (stdio tail lost)
    std::vector<long long> st = raw_stats(t);
    std::vector<long long> order;
    order.reserve(n);
    ErrClass err = t.pending;
    const char* msg = nullptr;
    for (long long i = 0; i < n; ++i) {
        const long long* o = st.data() + i * 7;
        if (o[0] + o[1] + o[4] + o[5] == 0) {
            err = ERR_SEGV;
            msg = "op-free cigar record (identity NaN assert)";
            break;
        }
        int code = check_full(t, i, st.data());
        if (code >= 0) {
            err = ERR_ABORT;
            msg = CHECK_MSG[code];
            break;
        }
        order.push_back(i);
    }
    return finish_stream(t, order, "trim", c.output, err, msg);
}

// ----------------------------------------------------------------- dechunk

// paffy dechunk (impl/paf_dechunk.c:24-38,114-117): decode name|len|start
// headers (sscanf leading-integer semantics; missing fields are the
// reference's assert class), shift coordinates, paf_check with spans.
int dechunk_main(int argc, char** argv) {
    static struct option lopts[] = {
        {"logLevel", required_argument, 0, 'l'},
        {"inputFile", required_argument, 0, 'i'},
        {"outputFile", required_argument, 0, 'o'},
        {"query", no_argument, 0, 'q'},
        {"target", no_argument, 0, 't'},
        {"help", no_argument, 0, 'h'},
        {0, 0, 0, 0}};
    CommonOpts c;
    bool only_query = false, only_target = false;
    const char* log_level = nullptr;
    opterr = 0;
    int key;
    while ((key = getopt_long(argc, argv, "l:i:o:qth", lopts, nullptr))
           != -1) {
        switch (key) {
            case 'l': log_level = optarg; break;
            case 'i': c.input = optarg; break;
            case 'o': c.output = optarg; break;
            case 'q': only_query = true; break;
            case 't': only_target = true; break;
            default: reexec_python(argc, argv);
        }
    }
    if (optind < argc) reexec_python(argc, argv);
    set_log_level(log_level, argc, argv);
    log_info("Input file string : %s", c.input ? c.input : "None");
    log_info("Output file string : %s", c.output ? c.output : "None");
    const bool fix_query = !only_target;
    const bool fix_target = !only_query;

    RawTable t;
    long long noncanon = 0;
    if (!read_all(c.input, t.buf)) {
        fprintf(stderr, "paffy: cannot read input\n");
        return 1;
    }
    if ((long long)t.buf.size() > fast_max_bytes())
        defer_python(c.input, t.buf);   // streaming lane wins above this
    if (!parse_raw(t, 1, &noncanon)) {
        fprintf(stderr, "paffy dechunk: cannot read input\n");
        return 1;
    }
    if (noncanon) defer_python(c.input, t.buf);
    const long long n = t.n;

    // decoded-name pool: one decode per distinct header, sscanf-style
    // leading-integer parse of the last two '|' fields
    struct Dec { long long off; long long start; long long length; bool ok; };
    std::unordered_map<std::string_view, Dec> cache;
    std::vector<char> pool2;
    auto decode = [&](const char* nm) -> const Dec& {
        auto it = cache.find(std::string_view(nm));
        if (it != cache.end()) return it->second;
        Dec d{-1, 0, 0, false};
        const char* end = nm + strlen(nm);
        const char* p2 = nullptr;   // last '|'
        const char* p1 = nullptr;   // second-to-last '|'
        for (const char* s = nm; s < end; ++s)
            if (*s == '|') { p1 = p2; p2 = s; }
        if (p1) {
            char* e = nullptr;
            errno = 0;
            long long start = strtoll(p2 + 1, &e, 10);
            bool ok1 = e != p2 + 1 && errno == 0;
            long long length = strtoll(p1 + 1, &e, 10);
            bool ok2 = e != p1 + 1 && errno == 0;
            if (ok1 && ok2) {
                d.off = (long long)pool2.size();
                pool2.insert(pool2.end(), nm, p1);
                pool2.push_back('\0');
                d.start = start;
                d.length = length;
                d.ok = true;
            }
        }
        return cache.emplace(std::string_view(nm), d).first->second;
    };

    std::vector<long long> q_off2(n, -1), t_off2(n, -1);
    long long dec_bad = -1;
    for (long long i = 0; i < n && dec_bad < 0; ++i) {
        long long* R = t.R(i);
        if (fix_query) {
            const Dec& d = decode(t.qname(i));
            if (!d.ok) { dec_bad = i; break; }
            q_off2[i] = d.off;
            R[1] += d.start; R[2] += d.start; R[0] = d.length;
        }
        if (fix_target) {
            const Dec& d = decode(t.tname(i));
            if (!d.ok) { dec_bad = i; break; }
            t_off2[i] = d.off;
            R[4] += d.start; R[5] += d.start; R[3] = d.length;
        }
    }
    // merge pools: rebase decoded offsets after the original pool
    const long long base = (long long)t.name_pool.size();
    t.name_pool.insert(t.name_pool.end(), pool2.begin(), pool2.end());
    for (long long i = 0; i < n; ++i) {
        if (q_off2[i] >= 0) t.qname_off[i] = base + q_off2[i];
        if (t_off2[i] >= 0) t.tname_off[i] = base + t_off2[i];
    }

    std::vector<long long> st = raw_stats(t);
    std::vector<long long> order;
    order.reserve(n);
    ErrClass err = t.pending;
    const char* msg = nullptr;
    const long long limit = dec_bad >= 0 ? dec_bad : n;
    for (long long i = 0; i < limit; ++i) {
        int code = check_full(t, i, st.data());
        if (code >= 0) {
            err = ERR_ABORT;
            msg = CHECK_MSG[code];
            break;
        }
        order.push_back(i);
    }
    if ((long long)order.size() == limit && dec_bad >= 0) {
        err = ERR_SEGV;   // decode_fasta_header assert: buffer tail lost
        msg = "fasta header lacks |length|start provenance fields";
    }
    return finish_stream(t, order, "dechunk", c.output, err, msg);
}

// ----------------------------------------------------------------- shatter

// paffy shatter (impl/paf.c:600-663 via impl/paf_shatter.c): full cigar
// parse, walk-assert validation, fused per-M-run line emission.
int shatter_main(int argc, char** argv) {
    static struct option lopts[] = {
        {"logLevel", required_argument, 0, 'l'},
        {"inputFile", required_argument, 0, 'i'},
        {"outputFile", required_argument, 0, 'o'},
        {"help", no_argument, 0, 'h'},
        {0, 0, 0, 0}};
    CommonOpts c;
    const char* log_level = nullptr;
    opterr = 0;
    int key;
    while ((key = getopt_long(argc, argv, "l:i:o:h", lopts, nullptr)) != -1) {
        switch (key) {
            case 'l': log_level = optarg; break;
            case 'i': c.input = optarg; break;
            case 'o': c.output = optarg; break;
            default: reexec_python(argc, argv);
        }
    }
    if (optind < argc) reexec_python(argc, argv);
    set_log_level(log_level, argc, argv);
    log_info("Input file string : %s", c.input ? c.input : "None");
    log_info("Output file string : %s", c.output ? c.output : "None");

    FullTable t;
    if (!read_all(c.input, t.buf)) {
        fprintf(stderr, "paffy shatter: cannot read input\n");
        return 1;
    }
    if ((long long)t.buf.size() > fast_max_bytes())
        defer_python(c.input, t.buf);
    if (!parse_full(t)) {
        fprintf(stderr, "paffy shatter: cannot read input\n");
        return 1;
    }
    long long n = t.n;
    ErrClass err = t.pending;
    const char* msg = nullptr;
    if (n) {
        // walk-assert + per-shard check validation, one native pass
        std::vector<unsigned char> strand(n);
        std::vector<long long> qs(n), qe(n), ql(n), ts(n), te(n), tl(n);
        for (long long i = 0; i < n; ++i) {
            const long long* R = t.R(i);
            strand[i] = t.flags[i] & 1;
            ql[i] = R[0]; qs[i] = R[1]; qe[i] = R[2];
            tl[i] = R[3]; ts[i] = R[4]; te[i] = R[5];
        }
        long long kind = 0;
        long long bad = shatter_violation(
            n, t.cig_off.data(), t.ops.data(), t.op_lens.data(),
            strand.data(), qs.data(), qe.data(), ql.data(), ts.data(),
            te.data(), tl.data(), &kind);
        if (bad >= 0) {
            n = bad;                      // shards of earlier records emit
            err = kind == 1 ? ERR_SEGV : ERR_ABORT;
            msg = kind == 1 ? "shatter walk assert"
                            : "shatter shard check failed";
        }
    }
    int fd = 1;
    if (c.output) {
        fd = open(c.output, O_WRONLY | O_CREAT | O_TRUNC, 0666);
        if (fd < 0) {
            fprintf(stderr, "paffy shatter: cannot open output: %s\n",
                    c.output);
            return 1;
        }
    }
    // windowed emission: shatter expands ~20x, so the output streams in
    // ~96 MB windows through the block writer instead of materializing
    // one multi-GB buffer (the 64x audit measured 1.66 GB RSS / 2.3x the
    // reference for the single-buffer form)
    BlockWriter bw(fd);
    if (n) {
        std::vector<long long> sizes(n), off(n + 1);
        shatter_serialize_sizes(n, t.ints.data(), t.flags.data(),
                                t.type.data(), t.qname_off.data(),
                                t.tname_off.data(), t.name_pool.data(),
                                t.ops.data(), t.op_lens.data(),
                                t.cig_off.data(), sizes.data(), g_threads());
        off[0] = 0;
        for (long long r = 0; r < n; ++r) off[r + 1] = off[r] + sizes[r];
        const long long WINDOW = 96ll << 20;
        std::vector<char> buf;
        std::vector<long long> w_off;
        long long a = 0;
        while (a < n) {
            long long bnd = a + 1;
            while (bnd < n && off[bnd + 1] - off[a] <= WINDOW) ++bnd;
            const long long wn = bnd - a;
            w_off.resize(wn + 1);
            for (long long j = 0; j <= wn; ++j)
                w_off[j] = off[a + j] - off[a];
            buf.resize(w_off[wn]);
            if (shatter_serialize_fill(
                    wn, t.ints.data() + a * 13, t.flags.data() + a,
                    t.type.data() + a, t.qname_off.data() + a,
                    t.tname_off.data() + a, t.name_pool.data(),
                    t.ops.data(), t.op_lens.data(), t.cig_off.data() + a,
                    w_off.data(), buf.data(), g_threads())) {
                fprintf(stderr, "paffy shatter: serializer drift\n");
                return 1;                      // cannot defer mid-stream
            }
            bw.write(buf.data(), (size_t)w_off[wn]);
            a = bnd;
        }
    }
    bw.finish(err);
    if (c.output) close(fd);
    if (err != ERR_NONE) {
        fprintf(stderr, "paffy shatter: %s\n",
                msg ? msg : "malformed paf input");
        return 1;
    }
    log_info("Paf shatter is done!, 0 seconds have elapsed");
    return 0;
}

}  // namespace

int main(int argc, char** argv) {
    g_argc = argc;
    g_argv = argv;
    if (argc < 2) reexec_python_full(argc, argv);
    if (getenv("PAFFY_TPU_PROFILE") || getenv("PAFFY_TPU_NO_FAST"))
        reexec_python_full(argc, argv);
    std::string cmd(argv[1]);
    // getopt scans argv[1:]: shift so the subcommand is not an operand
    int sub_argc = argc - 1;
    char** sub_argv = argv + 1;
    optind = 1;
    if (cmd == "dedupe") return dedupe_main(sub_argc, sub_argv);
    if (cmd == "split_file") return split_file_main(sub_argc, sub_argv);
    if (cmd == "invert") return invert_main(sub_argc, sub_argv);
    if (cmd == "filter") return filter_main(sub_argc, sub_argv);
    if (cmd == "trim") return trim_main(sub_argc, sub_argv);
    if (cmd == "dechunk") return dechunk_main(sub_argc, sub_argv);
    if (cmd == "shatter") return shatter_main(sub_argc, sub_argv);
    reexec_python_full(argc, argv);   // chain (K6 on the card) and the rest
}
