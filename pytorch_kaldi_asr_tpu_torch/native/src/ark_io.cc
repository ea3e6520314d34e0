// Kaldi ark/scp binary parsing core: the port's copy of the JAX package's
// native/src/ark_io.cc, giving the values of the port's Python readers
// (io/kaldi_io.py) bit for bit.
//
// - Header-only frame counts (feat-to-len), matrix reads at an offset of
//   a file the caller holds open (one open per read: the caller's, which
//   peeked at the header), and header scans of a whole archive.
// - CM, CM2 and CM3 decode in double arithmetic, rounded once to float32,
//   in the order of io/kaldi_io.py's _decode_cm* (numpy's float64).  Build
//   with -ffp-contract=off so no multiply-add is fused.
// - DM stays float64 (pka_read_mat_fd's want_double), as
//   _read_matrix_binary returns it.
// - pka_scan_ark tells a full buffer (-2) apart from a parse error (-1).
//
// Exposed as a C ABI in the port's native library (native/__init__.py);
// the CLIs live in tools_main.cc.

#include <fcntl.h>
#include <unistd.h>

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum Kind { kFM = 0, kDM = 1, kCM = 2, kCM2 = 3, kCM3 = 4 };

struct Header {
  int kind;
  int32_t rows, cols;
  float min_value, range;
  long data;  // the file offset of the data
};

// Read exactly n bytes at a file offset (pread: the descriptor's own
// offset is left alone).
bool pread_exact(int fd, void* dst, size_t n, long offset) {
  char* p = static_cast<char*>(dst);
  while (n > 0) {
    const ssize_t got = pread(fd, p, n, offset);
    if (got < 0 && errno == EINTR) continue;
    if (got <= 0) return false;
    p += got;
    n -= static_cast<size_t>(got);
    offset += got;
  }
  return true;
}

// Parse the header of the object at a file offset: the "\0B" binary
// marker, a token ("FM ", "CM2 ", ...) and the shape.  One read of the
// header's bytes.  Returns 0 on success.
int read_header(int fd, long offset, Header* h) {
  unsigned char buf[32];
  ssize_t n;
  do {
    n = pread(fd, buf, sizeof buf, offset);
  } while (n < 0 && errno == EINTR);
  if (n < 3 || buf[0] != 0 || buf[1] != 'B') return -1;
  size_t pos = 2;
  std::string tok;
  while (pos < static_cast<size_t>(n) && buf[pos] != ' ' && tok.size() < 8)
    tok.push_back(static_cast<char>(buf[pos++]));
  if (pos >= static_cast<size_t>(n) || buf[pos] != ' ' || tok.empty())
    return -1;
  ++pos;
  auto need = [&](size_t k) { return pos + k <= static_cast<size_t>(n); };
  if (tok == "FM" || tok == "DM") {
    h->kind = (tok == "FM") ? kFM : kDM;
    if (!need(10) || buf[pos] != 4 || buf[pos + 5] != 4) return -1;
    memcpy(&h->rows, buf + pos + 1, 4);
    memcpy(&h->cols, buf + pos + 6, 4);
    pos += 10;
  } else if (tok == "CM" || tok == "CM2" || tok == "CM3") {
    h->kind = (tok == "CM") ? kCM : (tok == "CM2" ? kCM2 : kCM3);
    if (!need(16)) return -1;
    memcpy(&h->min_value, buf + pos, 4);
    memcpy(&h->range, buf + pos + 4, 4);
    memcpy(&h->rows, buf + pos + 8, 4);
    memcpy(&h->cols, buf + pos + 12, 4);
    pos += 16;
  } else {
    return -1;
  }
  if (h->rows < 0 || h->cols < 0) return -1;
  h->data = offset + static_cast<long>(pos);
  return 0;
}

// The bytes of the data after a header.
long data_bytes(const Header& h) {
  const long n = static_cast<long>(h.rows) * h.cols;
  switch (h.kind) {
    case kFM: return n * 4;
    case kDM: return n * 8;
    case kCM: return 8L * h.cols + n;
    case kCM2: return n * 2;
    default: return n;
  }
}

// _uint16_to_float: min_value + range * (value / 65535.0), in double.
double cm_u16_to_double(uint16_t v, double min_value, double range) {
  return min_value + range * (static_cast<double>(v) / 65535.0);
}

// Decode an FM, CM, CM2 or CM3 object's data into out (rows*cols floats,
// row-major).  Returns 0 on success.
int decode_float(int fd, const Header& h, float* out) {
  const size_t rows = h.rows, cols = h.cols, n = rows * cols;
  const double mn = h.min_value, rg = h.range;
  if (h.kind == kFM) return pread_exact(fd, out, n * 4, h.data) ? 0 : -1;
  if (h.kind == kCM) {  // per-column headers + uint8 codes, column-major
    std::vector<uint16_t> headers(4 * cols);
    std::vector<uint8_t> codes(n);
    if (!pread_exact(fd, headers.data(), headers.size() * 2, h.data) ||
        !pread_exact(fd, codes.data(), n, h.data + 8L * h.cols))
      return -1;
    for (size_t c = 0; c < cols; ++c) {
      const uint16_t* hc = headers.data() + 4 * c;
      const double p0 = cm_u16_to_double(hc[0], mn, rg);
      const double p25 = cm_u16_to_double(hc[1], mn, rg);
      const double p75 = cm_u16_to_double(hc[2], mn, rg);
      const double p100 = cm_u16_to_double(hc[3], mn, rg);
      const uint8_t* col = codes.data() + c * rows;
      for (size_t i = 0; i < rows; ++i) {
        const double code = col[i];
        double v;
        if (code <= 64) {
          v = p0 + (p25 - p0) * (code / 64.0);
        } else if (code <= 192) {
          v = p25 + (p75 - p25) * ((code - 64.0) / 128.0);
        } else {
          v = p75 + (p100 - p75) * ((code - 192.0) / 63.0);
        }
        out[i * cols + c] = static_cast<float>(v);
      }
    }
    return 0;
  }
  if (h.kind == kCM2) {  // uint16, row-major
    std::vector<uint16_t> codes(n);
    if (!pread_exact(fd, codes.data(), n * 2, h.data)) return -1;
    for (size_t i = 0; i < n; ++i)
      out[i] = static_cast<float>(
          mn + rg * (static_cast<double>(codes[i]) / 65535.0));
    return 0;
  }
  if (h.kind == kCM3) {  // uint8, row-major
    std::vector<uint8_t> codes(n);
    if (!pread_exact(fd, codes.data(), n, h.data)) return -1;
    for (size_t i = 0; i < n; ++i)
      out[i] = static_cast<float>(
          mn + rg * (static_cast<double>(codes[i]) / 255.0));
    return 0;
  }
  return -1;
}

// The matrix at a file offset into out: floats for FM, CM, CM2 and CM3,
// doubles for a DM (want_double says which the caller holds).
int read_object(int fd, long offset, void* out, int32_t max_rows,
                int32_t max_cols, bool want_double) {
  Header h;
  if (read_header(fd, offset, &h) != 0 || (h.kind == kDM) != want_double ||
      h.rows > max_rows || h.cols > max_cols)
    return -1;
  if (h.kind == kDM)
    return pread_exact(fd, out, static_cast<size_t>(data_bytes(h)), h.data)
               ? 0
               : -1;
  return decode_float(fd, h, static_cast<float*>(out));
}

// A file opened for reading, closed with the scope.
struct Fd {
  int fd;
  explicit Fd(const char* path) : fd(open(path, O_RDONLY | O_CLOEXEC)) {}
  ~Fd() {
    if (fd >= 0) close(fd);
  }
};

}  // namespace

extern "C" {

// The kind (0 FM, 1 DM, 2 CM, 3 CM2, 4 CM3) and shape of the matrix at an
// offset of an open file, from its header alone.
int pka_mat_header_fd(int fd, long offset, int32_t* kind, int32_t* rows,
                      int32_t* cols) {
  Header h;
  if (read_header(fd, offset, &h) != 0) return -1;
  *kind = h.kind;
  *rows = h.rows;
  *cols = h.cols;
  return 0;
}

// The shape of the matrix at a file offset (an scp rxfilename
// "path:offset"), from its header alone: the JAX core's entry point,
// pka-feat-to-len's.
int pka_mat_shape(const char* path, long offset, int32_t* rows,
                  int32_t* cols) {
  Fd f(path);
  int32_t kind;
  if (f.fd < 0) return -1;
  return pka_mat_header_fd(f.fd, offset, &kind, rows, cols);
}

// Read the matrix at an offset of an open file into a caller buffer of
// rows*cols floats (FM, CM, CM2, CM3) or doubles (DM, want_double 1);
// query the header first.
int pka_read_mat_fd(int fd, long offset, void* out, int32_t max_rows,
                    int32_t max_cols, int want_double) {
  return read_object(fd, offset, out, max_rows, max_cols, want_double != 0);
}

// Scan a whole binary archive: write its keys (newline-joined, into the
// caller's buffer) and each matrix's rows and cols.  Returns the number of
// matrices; -2 when the key buffer or max_entries is too small for the
// archive (grow them and scan again); -1 on a parse error.
int pka_scan_ark(const char* path, char* keys_buf, long keys_buf_size,
                 int32_t* rows_out, int32_t* cols_out, int32_t max_entries) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  long keys_pos = 0;
  int count = 0, rc = 0;
  while (true) {
    // a whitespace-delimited key, then the object's header
    std::string key;
    int c;
    while ((c = fgetc(f)) != EOF && (c == ' ' || c == '\n' || c == '\t')) {
    }
    if (c == EOF) break;
    if (count == max_entries) {
      rc = -2;
      break;
    }
    key.push_back(static_cast<char>(c));
    while ((c = fgetc(f)) != EOF && c != ' ' && c != '\n' && c != '\t')
      key.push_back(static_cast<char>(c));
    Header h;
    if (read_header(fileno(f), ftell(f), &h) != 0 ||
        fseek(f, h.data + data_bytes(h), SEEK_SET) != 0) {
      rc = -1;
      break;
    }
    if (keys_pos + static_cast<long>(key.size()) + 1 >= keys_buf_size) {
      rc = -2;
      break;
    }
    memcpy(keys_buf + keys_pos, key.data(), key.size());
    keys_pos += static_cast<long>(key.size());
    keys_buf[keys_pos++] = '\n';
    rows_out[count] = h.rows;
    cols_out[count] = h.cols;
    ++count;
  }
  fclose(f);
  if (rc != 0) return rc;
  if (keys_pos < keys_buf_size) keys_buf[keys_pos] = '\0';
  return count;
}

}  // extern "C"
