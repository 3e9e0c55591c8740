// Native couplings-row formatter.
//
// Role in the reference: apegrunt's Graph_output_formatter streamed
// rows "pos1 pos2 distance aracne_flag mi" through C++ iostreams
// (consumed at src/SpydrPick.cpp:442-446; format per README
// "Deciphering SpydrPick output").  The Python np.char formatting this
// replaces ran ~25 us/row — 250 s for the ~1e7-edge default output.
//
// Integers are hand-formatted; the fixed-6-decimal MI field goes
// through snprintf("%.6f"), whose correctly-rounded decimal output is
// byte-identical to Python's f"{x:.6f}" (both round-half-even on the
// exact decimal expansion) — the golden byte-identity fixtures lock
// this.  OpenMP formats per-thread chunks, then one ordered memcpy.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

static inline char* put_i64(char* p, int64_t v) {
    if (v < 0) {
        *p++ = '-';
        v = -v;
    }
    char tmp[24];
    int n = 0;
    uint64_t u = static_cast<uint64_t>(v);
    do {
        tmp[n++] = static_cast<char>('0' + (u % 10));
        u /= 10;
    } while (u);
    while (n) *p++ = tmp[--n];
    return p;
}

extern "C" int64_t spydrpick_format_couplings(
    const int64_t* p1, const int64_t* p2, const int64_t* dist,
    const uint8_t* flags, const double* mi, int64_t n,
    char* out, int64_t cap) {
    if (n == 0) return 0;
    int nt = 1;
#ifdef _OPENMP
    nt = omp_get_max_threads();
    if (nt > 16) nt = 16;
    if (nt < 1) nt = 1;
#endif
    const int64_t chunk = (n + nt - 1) / nt;
    std::vector<std::string> bufs(static_cast<size_t>(nt));
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(nt)
#endif
    for (int t = 0; t < nt; ++t) {
        const int64_t lo = static_cast<int64_t>(t) * chunk;
        const int64_t hi = std::min(n, lo + chunk);
        if (lo >= hi) continue;
        std::string& s = bufs[static_cast<size_t>(t)];
        s.reserve(static_cast<size_t>((hi - lo) * 40));
        // worst case: three 20-char int64 fields + flag + 4 separators +
        // a 63-char clamped MI field + '\n' = 129 bytes; 192 is headroom
        char row[192];
        for (int64_t k = lo; k < hi; ++k) {
            char* p = row;
            p = put_i64(p, p1[k]);
            *p++ = ' ';
            p = put_i64(p, p2[k]);
            *p++ = ' ';
            p = put_i64(p, dist[k]);
            *p++ = ' ';
            *p++ = static_cast<char>('0' + (flags[k] ? 1 : 0));
            *p++ = ' ';
            // snprintf returns the WOULD-BE length on truncation; clamp
            // the advance so a pathological MI (|mi| >= ~1e57, inf/nan
            // garbage) cannot walk p past the buffer it wrote into
            int w = snprintf(p, 64, "%.6f", mi[k]);
            if (w < 0) w = 0;
            p += (w < 64 ? w : 63);
            *p++ = '\n';
            s.append(row, static_cast<size_t>(p - row));
        }
    }
    int64_t total = 0;
    for (const auto& s : bufs) total += static_cast<int64_t>(s.size());
    if (total > cap) return -1;
    char* p = out;
    for (const auto& s : bufs) {
        std::memcpy(p, s.data(), s.size());
        p += s.size();
    }
    return total;
}
