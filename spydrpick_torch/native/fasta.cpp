// Native FASTA alignment parser.
//
// Role of apegrunt's FASTA front-end (reference call site
// src/SpydrPick.cpp:163 via apegrunt::get_alignments). Two-pass over an
// mmapped file: pass 1 indexes records and validates rectangularity,
// pass 2 decodes sequence bytes through a 256-entry LUT (A,C,G,T -> 0..3
// case-insensitively, everything else -> gap=4; reference README.md:42)
// in parallel over records.
//
// Build: g++ -O3 -std=c++17 -fopenmp -shared -fPIC fasta.cpp -o libfasta.so

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool ok() const { return data != nullptr; }
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
  return true;
}

inline bool is_ws(char c) {
  return c == '\n' || c == '\r' || c == '\t' || c == ' ';
}

struct Record {
  size_t header_begin, header_end;  // header text (after '>', before newline)
  size_t seq_begin, seq_end;        // raw byte range containing the sequence
};

// Index all records. Returns false on malformed input.
bool index_records(const Mapped& m, std::vector<Record>& recs) {
  const char* d = m.data;
  size_t n = m.size;
  size_t i = 0;
  while (i < n && is_ws(d[i])) ++i;
  if (i >= n || d[i] != '>') return false;
  while (i < n) {
    // at '>'
    size_t h0 = i + 1;
    size_t h1 = h0;
    while (h1 < n && d[h1] != '\n') ++h1;
    size_t s0 = (h1 < n) ? h1 + 1 : n;
    size_t s1 = s0;
    while (s1 < n && d[s1] != '>') ++s1;
    recs.push_back({h0, h1, s0, s1});
    i = s1;
  }
  return true;
}

int8_t g_lut[256];
bool g_lut_init = false;

void init_lut() {
  if (g_lut_init) return;
  for (int i = 0; i < 256; ++i) g_lut[i] = 4;
  const char* sym = "ACGT";
  for (int s = 0; s < 4; ++s) {
    g_lut[(unsigned char)sym[s]] = (int8_t)s;
    g_lut[(unsigned char)(sym[s] + 32)] = (int8_t)s;
  }
  g_lut_init = true;
}

size_t seq_len(const Mapped& m, const Record& r) {
  size_t len = 0;
  for (size_t i = r.seq_begin; i < r.seq_end; ++i) {
    if (!is_ws(m.data[i])) ++len;
  }
  return len;
}

}  // namespace

extern "C" {

// Pass 1: index. Returns 0 on success; fills n_records and width.
// Error codes: -1 open/map failure, -2 malformed, -3 unaligned widths.
int spydrpick_fasta_index(const char* path, int64_t* n_records, int64_t* width) {
  Mapped m;
  if (!map_file(path, m)) return -1;
  std::vector<Record> recs;
  if (!index_records(m, recs) || recs.empty()) return -2;
  int64_t w = -1;
  for (const auto& r : recs) {
    int64_t len = (int64_t)seq_len(m, r);
    if (w < 0) w = len;
    else if (len != w) return -3;
  }
  *n_records = (int64_t)recs.size();
  *width = w;
  return 0;
}

// Pass 2: decode into out (n_records * width uint8, row-major) and copy
// headers into namebuf as NUL-separated strings (truncated to cap).
// Returns 0 on success, -4 if shapes mismatch pass 1.
int spydrpick_fasta_parse(const char* path, uint8_t* out, int64_t n_records,
                          int64_t width, char* namebuf, int64_t namebuf_cap) {
  init_lut();
  Mapped m;
  if (!map_file(path, m)) return -1;
  std::vector<Record> recs;
  if (!index_records(m, recs)) return -2;
  if ((int64_t)recs.size() != n_records) return -4;

  int err = 0;
#pragma omp parallel for schedule(dynamic, 8)
  for (int64_t r = 0; r < n_records; ++r) {
    const Record& rec = recs[r];
    uint8_t* row = out + r * width;
    int64_t k = 0;
    for (size_t i = rec.seq_begin; i < rec.seq_end; ++i) {
      char c = m.data[i];
      if (is_ws(c)) continue;
      if (k >= width) { err = -4; break; }
      row[k++] = (uint8_t)g_lut[(unsigned char)c];
    }
    if (k != width) err = -4;
  }
  if (err) return err;

  // headers (first token of each) serially
  int64_t off = 0;
  for (const auto& rec : recs) {
    size_t b = rec.header_begin;
    while (b < rec.header_end && is_ws(m.data[b])) ++b;
    size_t e = b;
    while (e < rec.header_end && !is_ws(m.data[e])) ++e;
    int64_t len = (int64_t)(e - b);
    if (off + len + 1 > namebuf_cap) return -5;
    memcpy(namebuf + off, m.data + b, len);
    off += len;
    namebuf[off++] = '\0';
  }
  return 0;
}

}  // extern "C"
