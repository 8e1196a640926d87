// Native ASIMoW CSV parser: the port's own copy of
// vq_vae_transformer_arc_welding_tpu/native/csv_parser.cpp.
//
// The reference's host-side input pipeline is pandas.read_csv plus 8
// DataLoader worker processes (asimow_dataloader.py:40-43, :357-365).
// Here the input pipeline is single-process (data feeds the device
// once, then lives in device memory), so the CSV parse is the only
// real host-side cost; this parser streams the file once with no
// intermediate DataFrame, writing directly into the packed
// (N, 200, 2) float32 + id arrays the data modules batch from.
//
// Layout contract (see data/asimow.py): three leading id columns
// located by header name (experiment, welding_run, labels), then
// V_0..V_199 and I_0..I_199 by position 3..402.
//
// C ABI for ctypes:
//   asimow_count_rows(path) -> int64 rows (-1 on error)
//   asimow_parse(path, vi[N*200*2], labels[N], experiment[N],
//                welding_run[N], n) -> rows parsed (-1 on error)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kCycleLen = 200;
constexpr int kNumCols = 3 + 2 * kCycleLen;

// fast float parse: strtod on a bounded token
inline double parse_tok(const char* s, char** end) { return strtod(s, end); }

struct HeaderInfo {
  int experiment = -1;
  int welding_run = -1;
  int labels = -1;
  int n_cols = 0;
  bool ok = false;
};

HeaderInfo parse_header(const std::string& line) {
  HeaderInfo h;
  int col = 0;
  size_t start = 0;
  while (start <= line.size()) {
    size_t comma = line.find(',', start);
    size_t end = comma == std::string::npos ? line.size() : comma;
    std::string name = line.substr(start, end - start);
    if (!name.empty() && name.back() == '\r') name.pop_back();
    if (name == "experiment") h.experiment = col;
    else if (name == "welding_run") h.welding_run = col;
    else if (name == "labels") h.labels = col;
    ++col;
    if (comma == std::string::npos) break;
    start = comma + 1;
  }
  h.n_cols = col;
  h.ok = h.experiment >= 0 && h.welding_run >= 0 && h.labels >= 0 &&
         col >= kNumCols;
  return h;
}

bool read_line(FILE* f, std::string* out) {
  out->clear();
  char buf[1 << 16];
  while (fgets(buf, sizeof(buf), f)) {
    out->append(buf);
    if (!out->empty() && out->back() == '\n') {
      out->pop_back();
      if (!out->empty() && out->back() == '\r') out->pop_back();
      return true;
    }
  }
  return !out->empty();
}

}  // namespace

extern "C" {

int64_t asimow_count_rows(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t rows = -1;  // header doesn't count
  int c;
  bool line_nonempty = false;
  while ((c = fgetc(f)) != EOF) {
    if (c == '\n') {
      if (line_nonempty) ++rows;
      line_nonempty = false;
    } else if (c != '\r') {
      line_nonempty = true;
    }
  }
  if (line_nonempty) ++rows;
  fclose(f);
  return rows < 0 ? 0 : rows;
}

int64_t asimow_parse(const char* path, float* vi, int64_t* labels,
                     int64_t* experiment, int64_t* welding_run, int64_t n) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  std::string line;
  if (!read_line(f, &line)) {
    fclose(f);
    return -1;
  }
  HeaderInfo h = parse_header(line);
  if (!h.ok) {
    fclose(f);
    return -1;
  }

  int64_t row = 0;
  std::vector<double> cols(h.n_cols);
  while (row < n && read_line(f, &line)) {
    if (line.empty()) continue;
    const char* p = line.c_str();
    char* end = nullptr;
    int col = 0;
    while (col < h.n_cols) {
      cols[col] = parse_tok(p, &end);
      if (end == p && *p != ',') break;  // malformed token
      ++col;
      p = (*end == ',') ? end + 1 : end;
      if (*end == '\0') break;
    }
    if (col < kNumCols) continue;  // skip malformed row
    experiment[row] = static_cast<int64_t>(cols[h.experiment]);
    welding_run[row] = static_cast<int64_t>(cols[h.welding_run]);
    labels[row] = static_cast<int64_t>(cols[h.labels]);
    float* out = vi + row * kCycleLen * 2;
    for (int t = 0; t < kCycleLen; ++t) {
      out[t * 2 + 0] = static_cast<float>(cols[3 + t]);               // V
      out[t * 2 + 1] = static_cast<float>(cols[3 + kCycleLen + t]);   // I
    }
    ++row;
  }
  fclose(f);
  return row;
}

}  // extern "C"
