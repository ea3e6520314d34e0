// The pka-tools binary over the native core: Kaldi's feat-to-len and
// compute-wer CLI contracts, chosen by the name it runs under (the links
// pka-feat-to-len and pka-compute-wer).  The port's copy of the JAX
// package's native/src/tools_main.cc: the same defaults (--mode=strict, scp
// input only) and the same three report lines, so its output is byte for
// byte that of tools/feat_to_len.py and tools/compute_wer.py.  Built with
// ark_io.cc and edit_distance.cc by native/__init__.py (tool_path).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <iostream>
#include <map>
#include <sstream>
#include <string>
#include <vector>

extern "C" int pka_mat_shape(const char* path, long offset, int32_t* rows,
                             int32_t* cols);
extern "C" int pka_edit_distance(const int32_t* ref, int32_t ref_len,
                                 const int32_t* hyp, int32_t hyp_len,
                                 int32_t* err, int32_t* ins, int32_t* del,
                                 int32_t* sub);

namespace {

std::string strip_specifier(const std::string& spec) {
  auto pos = spec.find(':');
  return pos == std::string::npos ? spec : spec.substr(pos + 1);
}

// "path:offset" -> (path, offset or -1)
void split_offset(const std::string& rx, std::string* path, long* offset) {
  auto pos = rx.rfind(':');
  *offset = -1;
  *path = rx;
  if (pos == std::string::npos) return;
  const std::string tail = rx.substr(pos + 1);
  if (!tail.empty() && tail.find_first_not_of("0123456789") ==
                           std::string::npos) {
    *path = rx.substr(0, pos);
    *offset = std::stol(tail);
  }
}

int feat_to_len_main(int argc, char** argv) {
  if (argc != 3) {
    std::cerr << "usage: pka-feat-to-len scp:feats.scp ark,t:out.length\n";
    return 1;
  }
  const std::string scp = strip_specifier(argv[1]);
  const std::string out = strip_specifier(argv[2]);
  std::ifstream in(scp);
  if (!in) {
    std::cerr << "cannot open " << scp << "\n";
    return 1;
  }
  std::ofstream os(out);
  if (!os) {
    std::cerr << "cannot open output " << out << "\n";
    return 1;
  }
  std::string key, rx;
  while (in >> key >> rx) {
    std::string path;
    long offset;
    split_offset(rx, &path, &offset);
    int32_t rows, cols;
    if (pka_mat_shape(path.c_str(), offset < 0 ? 0 : offset, &rows,
                      &cols) != 0) {
      std::cerr << "bad matrix for " << key << " at " << rx << "\n";
      return 1;
    }
    os << key << " " << rows << "\n";
  }
  os.flush();
  if (!os) {
    std::cerr << "write to " << out << " failed\n";
    return 1;
  }
  return 0;
}

using Table = std::map<std::string, std::vector<std::string>>;

Table read_text_table(const std::string& path) {
  Table t;
  std::ifstream in(path);
  std::string line;
  while (std::getline(in, line)) {
    std::istringstream ss(line);
    std::string key, w;
    if (!(ss >> key)) continue;
    std::vector<std::string> words;
    while (ss >> w) words.push_back(w);
    t[key] = words;
  }
  return t;
}

int compute_wer_main(int argc, char** argv) {
  std::string mode = "strict";
  std::vector<std::string> rest;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    if (a.rfind("--mode=", 0) == 0) {
      mode = a.substr(7);
    } else {
      rest.push_back(a);
    }
  }
  if (rest.size() != 2) {
    std::cerr << "usage: pka-compute-wer [--mode=present|all|strict] "
                 "ark:ref ark:hyp\n";
    return 1;
  }
  Table ref = read_text_table(strip_specifier(rest[0]));
  Table hyp = read_text_table(strip_specifier(rest[1]));

  std::map<std::string, int32_t> ids;
  auto to_ids = [&](const std::vector<std::string>& words) {
    std::vector<int32_t> out;
    out.reserve(words.size());
    for (const auto& w : words) {
      auto it = ids.find(w);
      if (it == ids.end())
        it = ids.emplace(w, static_cast<int32_t>(ids.size())).first;
      out.push_back(it->second);
    }
    return out;
  };

  long n_err = 0, n_ins = 0, n_del = 0, n_sub = 0, n_words = 0;
  long n_sent = 0, n_sent_err = 0, n_absent = 0;
  for (const auto& kv : ref) {
    auto hit = hyp.find(kv.first);
    std::vector<std::string> hyp_words;
    if (hit == hyp.end()) {
      if (mode == "present") {
        ++n_absent;
        continue;
      }
      if (mode == "strict") {
        std::cerr << "no hypothesis for " << kv.first << "\n";
        return 1;
      }
    } else {
      hyp_words = hit->second;
    }
    auto r = to_ids(kv.second);
    auto h = to_ids(hyp_words);
    int32_t err, ins, del, sub;
    pka_edit_distance(r.data(), static_cast<int32_t>(r.size()), h.data(),
                      static_cast<int32_t>(h.size()), &err, &ins, &del,
                      &sub);
    n_err += err;
    n_ins += ins;
    n_del += del;
    n_sub += sub;
    n_words += static_cast<long>(r.size());
    ++n_sent;
    if (err) ++n_sent_err;
  }
  const double wer = 100.0 * n_err / (n_words ? n_words : 1);
  const double ser = 100.0 * n_sent_err / (n_sent ? n_sent : 1);
  std::printf("%%WER %.2f [ %ld / %ld, %ld ins, %ld del, %ld sub ]\n", wer,
              n_err, n_words, n_ins, n_del, n_sub);
  std::printf("%%SER %.2f [ %ld / %ld ]\n", ser, n_sent_err, n_sent);
  std::printf(
      "Scored %ld sentences, %ld sentences failed to be scored.\n", n_sent,
      n_absent);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  const char* name = std::strrchr(argv[0], '/');
  std::string prog = name ? name + 1 : argv[0];
  if (prog.find("feat-to-len") != std::string::npos)
    return feat_to_len_main(argc, argv);
  if (prog.find("compute-wer") != std::string::npos)
    return compute_wer_main(argc, argv);
  std::cerr << "unknown tool name " << prog << "\n";
  return 1;
}
