// Native MultiSlot text parser: the port's copy of
// paddle_tpu/native/datafeed.cpp (host code, built with g++ at first use
// by datafeed.py into native/build/).
//
// Reference: paddle/fluid/framework/data_feed.cc MultiSlotDataFeed —
// C++ multi-threaded file->channel sample parsing so the training loop
// never waits on Python text parsing. Same role here: this library does
// the byte-level parsing; Python threads call it with the GIL released
// (ctypes), giving true parallel file ingest.
//
// Format per line, per slot:  <n> v1 v2 ... vn
//
// Build: g++ -O2 -shared -fPIC -o libptfeed.so datafeed.cpp

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct SlotData {
  std::vector<int64_t> lengths;   // per sample
  std::vector<float> fvals;       // used when slot is float
  std::vector<int64_t> ivals;     // used when slot is int
  bool is_float = true;
};

struct ParseResult {
  std::vector<SlotData> slots;
  int64_t num_samples = 0;
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

}  // namespace

extern "C" {

void* pt_parse_file(const char* path, int num_slots,
                    const unsigned char* slot_is_float) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize(size);
  if (size > 0 && std::fread(&buf[0], 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);

  auto* res = new ParseResult();
  res->slots.resize(num_slots);
  for (int s = 0; s < num_slots; ++s) res->slots[s].is_float = slot_is_float[s];

  char* p = buf.empty() ? nullptr : &buf[0];
  char* end = p + buf.size();
  while (p && p < end) {
    char* line_end = static_cast<char*>(memchr(p, '\n', end - p));
    bool had_nl = line_end != nullptr;
    if (!line_end) line_end = end;
    // NUL-terminate the line in place so strtof/strtoll cannot read
    // past it into the next line (silent cross-line corruption)
    char saved = *line_end;
    if (line_end < end) *line_end = '\0';
    const char* q = skip_ws(p, line_end);
    if (q < line_end) {
      bool ok = true;
      // remember sizes for exact rollback of a malformed line
      std::vector<size_t> fsz(num_slots), isz(num_slots), lsz(num_slots);
      for (int s = 0; s < num_slots; ++s) {
        fsz[s] = res->slots[s].fvals.size();
        isz[s] = res->slots[s].ivals.size();
        lsz[s] = res->slots[s].lengths.size();
      }
      for (int s = 0; s < num_slots && ok; ++s) {
        q = skip_ws(q, line_end);
        char* next = nullptr;
        long n = std::strtol(q, &next, 10);
        if (next == q || n < 0) { ok = false; break; }
        q = next;
        SlotData& sd = res->slots[s];
        sd.lengths.push_back(n);
        for (long i = 0; i < n; ++i) {
          q = skip_ws(q, line_end);
          if (sd.is_float) {
            float v = std::strtof(q, &next);
            if (next == q) { ok = false; break; }
            sd.fvals.push_back(v);
          } else {
            long long v = std::strtoll(q, &next, 10);
            if (next == q) { ok = false; break; }
            sd.ivals.push_back(v);
          }
          q = next;
        }
      }
      if (ok) {
        res->num_samples++;
      } else {
        for (int s = 0; s < num_slots; ++s) {
          SlotData& sd = res->slots[s];
          sd.fvals.resize(fsz[s]);
          sd.ivals.resize(isz[s]);
          sd.lengths.resize(lsz[s]);
        }
      }
    }
    if (line_end < end) *line_end = saved;
    p = line_end + (had_nl ? 1 : 0);
    if (!had_nl) break;
  }
  return res;
}

int64_t pt_samples(void* h) {
  return h ? static_cast<ParseResult*>(h)->num_samples : -1;
}

int64_t pt_slot_total(void* h, int slot) {
  auto* r = static_cast<ParseResult*>(h);
  const SlotData& sd = r->slots[slot];
  return sd.is_float ? sd.fvals.size() : sd.ivals.size();
}

void pt_slot_lengths(void* h, int slot, int64_t* out) {
  auto* r = static_cast<ParseResult*>(h);
  const auto& L = r->slots[slot].lengths;
  std::memcpy(out, L.data(), L.size() * sizeof(int64_t));
}

void pt_slot_values_f(void* h, int slot, float* out) {
  auto* r = static_cast<ParseResult*>(h);
  const auto& v = r->slots[slot].fvals;
  std::memcpy(out, v.data(), v.size() * sizeof(float));
}

void pt_slot_values_i(void* h, int slot, int64_t* out) {
  auto* r = static_cast<ParseResult*>(h);
  const auto& v = r->slots[slot].ivals;
  std::memcpy(out, v.data(), v.size() * sizeof(int64_t));
}

void pt_release(void* h) { delete static_cast<ParseResult*>(h); }

}  // extern "C"
