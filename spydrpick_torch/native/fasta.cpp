// Native FASTA alignment parser.
//
// Role of apegrunt's FASTA front-end (reference call site
// src/SpydrPick.cpp:163 via apegrunt::get_alignments). The file is mapped
// once and walked in parallel:
//   index  (spydrpick_fasta_index): the file is cut into byte ranges; each
//          range finds its record starts with memchr, the ranges' records
//          are joined in file order, and each record's width (its
//          non-whitespace bytes) is counted in parallel over records and
//          checked against the first record's. The mapping and the record
//          table stay in an opaque handle;
//   decode (spydrpick_fasta_decode): per record in parallel, each line is
//          found with memchr and decoded by a branch-free loop (A,C,G,T ->
//          0..3 case-insensitively, everything else -> gap=4; reference
//          README.md:42); a line holding interior whitespace is decoded
//          again by a per-byte loop that skips it. Then the names are
//          copied;
//   free   (spydrpick_fasta_free): the mapping and the table released.
//
// A record starts at the first '>' of a line: a '>' anywhere in a sequence
// line starts a record, one after it on a header line does not. Its header
// runs to the end of that line, its sequence to the next record's start.
// Whitespace ('\n', '\r', '\t', ' ') may precede the first record and lies
// anywhere in a sequence without counting.
//
// Build: g++ -O3 -std=c++17 -fopenmp -shared -fPIC fasta.cpp -o libfasta.so

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <omp.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  ~Mapped() {
    if (data) munmap(const_cast<char*>(data), size);
    if (fd >= 0) close(fd);
  }
};

bool map_file(const char* path, Mapped& m) {
  m.fd = open(path, O_RDONLY);
  if (m.fd < 0) return false;
  struct stat st;
  if (fstat(m.fd, &st) != 0 || st.st_size == 0) return false;
  m.size = (size_t)st.st_size;
  void* p = mmap(nullptr, m.size, PROT_READ, MAP_PRIVATE, m.fd, 0);
  if (p == MAP_FAILED) return false;
  m.data = (const char*)p;
  // Read ahead of the threads, which then fault their own pages in
  // parallel: faster than MAP_POPULATE's serial population on a file in
  // the page cache (PERF.md, PR 16).
  madvise(p, m.size, MADV_SEQUENTIAL);
  madvise(p, m.size, MADV_WILLNEED);
  return true;
}

inline bool is_ws(char c) {
  return c == '\n' || c == '\r' || c == '\t' || c == ' ';
}

struct Record {
  size_t header_begin, header_end;  // header text (after '>', before newline)
  size_t seq_begin, seq_end;        // raw byte range containing the sequence
};

// What the index call hands to the decode call.
struct Parse {
  Mapped m;
  std::vector<Record> recs;
  int64_t width = 0;
};

// The records whose '>' lies in [a, b): each '>' there that is the first of
// its line. Only header_begin and header_end are set.
void starts_in(const char* d, size_t n, size_t a, size_t b, std::vector<Record>& out) {
  size_t pos = a;  // [pos, the next '>') holds no '>'
  while (pos < b) {
    const char* q = (const char*)memchr(d + pos, '>', b - pos);
    if (!q) break;
    size_t i = (size_t)(q - d);
    bool first = i == 0 || d[i - 1] == '\n';
    if (!first) {
      const char* nl = (const char*)memrchr(d, '\n', i);
      size_t line = nl ? (size_t)(nl - d) + 1 : 0;
      first = line >= pos || !memchr(d + line, '>', pos - line);
    }
    const char* e = (const char*)memchr(d + i + 1, '\n', n - i - 1);
    size_t h1 = e ? (size_t)(e - d) : n;
    if (first) out.push_back({i + 1, h1, 0, 0});
    pos = h1 + 1;  // the rest of the line is a header
  }
}

// Whitespace bytes in [p, p + len), in blocks the compiler vectorises.
size_t count_ws(const unsigned char* p, size_t len) {
  size_t total = 0;
  while (len) {
    size_t m = len < 65536 ? len : 65536;
    uint32_t c = 0;
    for (size_t i = 0; i < m; ++i) {
      unsigned char x = p[i];
      c += (x == '\n') + (x == '\r') + (x == '\t') + (x == ' ');  // not |: that stops vectorising
    }
    total += c;
    p += m;
    len -= m;
  }
  return total;
}

// A, C, G, T -> 0..3 in either case, any other byte -> 4, without a branch.
inline uint8_t code_of(unsigned char c) {
  unsigned char u = c | 0x20;  // 'A' -> 'a'; no other byte maps to a, c, g, t
  return (uint8_t)(4 - 4 * (u == 'a') - 3 * (u == 'c') - 2 * (u == 'g') - (u == 't'));
}

// Decodes [p, p + len) into out in a loop the compiler vectorises; false if
// the bytes hold whitespace (out then holds no codes).
bool decode_line(const unsigned char* p, size_t len, uint8_t* out) {
  unsigned char ws = 0;
  for (size_t i = 0; i < len; ++i) {
    unsigned char c = p[i];
    out[i] = code_of(c);
    ws |= (c == '\r') | (c == '\t') | (c == ' ');
  }
  return ws == 0;
}

// Decodes rec's sequence into row (width codes); returns 0 or -4, and sets
// slow when a line held interior whitespace.
int decode_record(const char* d, const Record& rec, uint8_t* row, int64_t width, bool& slow) {
  const unsigned char* u = (const unsigned char*)d;
  int64_t k = 0;
  size_t ls = rec.seq_begin;
  while (ls < rec.seq_end) {
    const char* nl = (const char*)memchr(d + ls, '\n', rec.seq_end - ls);
    size_t le = nl ? (size_t)(nl - d) : rec.seq_end;
    size_t e = (le > ls && d[le - 1] == '\r') ? le - 1 : le;
    int64_t len = (int64_t)(e - ls);
    if (len <= width - k && decode_line(u + ls, (size_t)len, row + k)) {
      k += len;
    } else {
      slow = true;
      for (size_t i = ls; i < le; ++i) {
        char c = d[i];
        if (is_ws(c)) continue;
        if (k >= width) return -4;
        row[k++] = code_of((unsigned char)c);
      }
    }
    ls = le + 1;
  }
  return k == width ? 0 : -4;
}

}  // namespace

extern "C" {

// OpenMP's thread count: the number of byte ranges the loader asks for.
int spydrpick_fasta_max_threads() { return omp_get_max_threads(); }

// Maps and indexes the file, cut into n_ranges byte ranges. Returns 0 on
// success, with *handle for spydrpick_fasta_decode and spydrpick_fasta_free,
// and n_records and width filled; on failure *handle is null.
// Error codes: -1 open/map failure, -2 malformed, -3 unaligned widths.
int spydrpick_fasta_index(const char* path, int64_t n_ranges, void** handle,
                          int64_t* n_records, int64_t* width) {
  *handle = nullptr;
  Parse* ps = new Parse;
  Mapped& m = ps->m;
  auto fail = [ps](int rc) { delete ps; return rc; };
  if (!map_file(path, m)) return fail(-1);
  const char* d = m.data;
  size_t n = m.size;
  size_t i0 = 0;
  while (i0 < n && is_ws(d[i0])) ++i0;
  if (i0 >= n || d[i0] != '>') return fail(-2);

  if (n_ranges < 1) n_ranges = 1;
  if ((size_t)n_ranges > n) n_ranges = (int64_t)n;
  std::vector<std::vector<Record>> parts(n_ranges);
#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t r = 0; r < n_ranges; ++r) {
    size_t a = (size_t)((unsigned __int128)n * r / n_ranges);
    size_t b = (size_t)((unsigned __int128)n * (r + 1) / n_ranges);
    starts_in(d, n, a, b, parts[r]);
  }
  std::vector<Record>& recs = ps->recs;
  for (auto& p : parts) recs.insert(recs.end(), p.begin(), p.end());
  if (recs.empty() || recs[0].header_begin != i0 + 1) return fail(-2);
  for (size_t r = 0; r < recs.size(); ++r) {
    recs[r].seq_begin = recs[r].header_end < n ? recs[r].header_end + 1 : n;
    recs[r].seq_end = r + 1 < recs.size() ? recs[r + 1].header_begin - 1 : n;
  }

  const int64_t S = (int64_t)recs.size();
  std::vector<int64_t> w(S);
#pragma omp parallel for schedule(dynamic, 8)
  for (int64_t r = 0; r < S; ++r) {
    const Record& rec = recs[r];
    size_t len = rec.seq_end - rec.seq_begin;
    w[r] = (int64_t)(len - count_ws((const unsigned char*)d + rec.seq_begin, len));
  }
  for (int64_t r = 1; r < S; ++r)
    if (w[r] != w[0]) return fail(-3);
  ps->width = w[0];
  *n_records = S;
  *width = w[0];
  *handle = ps;
  return 0;
}

// Decodes into out (n_records * width uint8, row-major) and copies the
// headers' first words into namebuf as NUL-terminated strings, *name_bytes
// bytes in all. Counts in *slow_records the records with a line that held
// interior whitespace. Returns 0 on success, -4 if the shapes are not the
// index's, -5 if the names do not fit in namebuf_cap bytes.
int spydrpick_fasta_decode(void* handle, uint8_t* out, int64_t n_records, int64_t width,
                           char* namebuf, int64_t namebuf_cap, int64_t* name_bytes,
                           int64_t* slow_records) {
  const Parse& ps = *(const Parse*)handle;
  if ((int64_t)ps.recs.size() != n_records || ps.width != width) return -4;
  const char* d = ps.m.data;

  int err = 0;
  int64_t slow = 0;
#pragma omp parallel for schedule(dynamic, 8) reduction(min : err) reduction(+ : slow)
  for (int64_t r = 0; r < n_records; ++r) {
    bool s = false;
    int rc = decode_record(d, ps.recs[r], out + r * width, width, s);
    if (rc < err) err = rc;
    slow += s;
  }
  if (err) return err;
  *slow_records = slow;

  int64_t off = 0;
  for (const auto& rec : ps.recs) {
    size_t b = rec.header_begin;
    while (b < rec.header_end && is_ws(d[b])) ++b;
    size_t e = b;
    while (e < rec.header_end && !is_ws(d[e])) ++e;
    int64_t len = (int64_t)(e - b);
    if (off + len + 1 > namebuf_cap) return -5;
    memcpy(namebuf + off, d + b, len);
    off += len;
    namebuf[off++] = '\0';
  }
  *name_bytes = off;
  return 0;
}

// Releases what spydrpick_fasta_index kept; null is a no-op.
void spydrpick_fasta_free(void* handle) { delete (Parse*)handle; }

}  // extern "C"
