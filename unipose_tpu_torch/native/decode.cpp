// Native data-pipeline core: threaded JPEG decode + optional crop + resize
// + float32 conversion directly into a preallocated batch buffer.
//
// The reference delegates this work to Python-level cv2 calls inside torch
// DataLoader worker *processes* (utils/lsp_lspet_data.py:211); here a C++
// thread pool fills the whole batch with zero Python involvement per sample
// — the host-side feeding path for training, where Python per-sample
// overhead would otherwise bound throughput.
//
// C ABI (ctypes-friendly); see unipose_tpu_torch/native/__init__.py.  A copy
// of unipose_tpu/native/decode.cpp.

#include <atomic>
#include <cstring>
#include <thread>
#include <vector>

#include <opencv2/core.hpp>
#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>

namespace {

struct Job {
  const char* path;
  // In-memory source (serving path): when buf != nullptr the job decodes
  // from this encoded byte buffer (cv::imdecode) instead of reading path.
  const unsigned char* buf = nullptr;
  int buf_len = 0;
  float* out;   // size*size*3 floats, BGR HWC
  int size;
  // crop (x0 <= -1 means no crop): crop the rectangle first, then resize.
  int crop_x0, crop_y0, crop_w, crop_h;
  // bottom_right_368: emulate BBC's img[-368:, -368:] crop when >0
  int bottom_right;
  // 0: u8 linear resize to (size, size) (the LSP/MPII dataset semantics,
  //    lsp_lspet_data.py:211 cv2.resize default).
  // 1: the Python TestResized float chain (Mytransforms.py:148-184 as
  //    reproduced by data/transforms.py::resize + the Penn loader's
  //    post-transform fixup): float32 convert FIRST, then INTER_CUBIC to
  //    dsize=(int(rows*(size/rows)), int(cols*(size/cols))) — the
  //    reference's h/w-derived dsize with Python's int() truncation, which
  //    genuinely lands on size-1 for some dims (e.g. rows=86 -> 367) —
  //    then an INTER_LINEAR fixup to (size, size) when the quirk fired.
  int mode;
  int status;  // 0 ok, 1 read failure (buffer zero-filled)
  int rows, cols;  // original (pre-crop/resize) image dims; 0 on failure
};

void run_job(Job& j) {
  cv::Mat img;
  if (j.buf != nullptr) {
    cv::Mat enc(1, j.buf_len, CV_8UC1, const_cast<unsigned char*>(j.buf));
    img = cv::imdecode(enc, cv::IMREAD_COLOR);
  } else {
    img = cv::imread(j.path, cv::IMREAD_COLOR);
  }
  if (img.empty()) {
    std::memset(j.out, 0, sizeof(float) * 3 * j.size * j.size);
    j.status = 1;
    j.rows = j.cols = 0;
    return;
  }
  j.rows = img.rows;
  j.cols = img.cols;
  if (j.bottom_right > 0 && img.rows >= j.bottom_right &&
      img.cols >= j.bottom_right) {
    img = img(cv::Rect(img.cols - j.bottom_right, img.rows - j.bottom_right,
                       j.bottom_right, j.bottom_right));
  } else if (j.crop_x0 >= 0) {
    cv::Rect r(j.crop_x0, j.crop_y0, j.crop_w, j.crop_h);
    r &= cv::Rect(0, 0, img.cols, img.rows);
    img = img(r);
  }
  cv::Mat out(j.size, j.size, CV_32FC3, j.out);
  if (j.mode == 1) {
    // Python float-TestResized chain; double math matches CPython's IEEE
    // arithmetic so the int() truncation fires for exactly the same dims.
    cv::Mat f;
    img.convertTo(f, CV_32FC3);
    // ratios from PRE-pad dims (TestResized reads img.shape before calling
    // resize(), whose <64px pad then widens the image the dsize is
    // computed from — Mytransforms.py:148-184 order, quirk kept)
    double r0 = static_cast<double>(j.size) / f.rows;
    double r1 = static_cast<double>(j.size) / f.cols;
    if (f.cols < 64) {
      cv::copyMakeBorder(f, f, 0, 0, 0, 64 - f.cols, cv::BORDER_CONSTANT,
                         cv::Scalar(128, 128, 128));
    }
    int dw = static_cast<int>(f.rows * r0);  // cv2 dsize WIDTH from rows —
    int dh = static_cast<int>(f.cols * r1);  // the reference's swap quirk
    cv::Mat tmp;
    if (f.rows == j.size && f.cols == j.size && dw == j.size &&
        dh == j.size) {
      tmp = f;  // same-size cubic resize is identity (pinned by tests)
    } else {
      cv::resize(f, tmp, cv::Size(dw, dh), 0, 0, cv::INTER_CUBIC);
    }
    if (tmp.rows != j.size || tmp.cols != j.size) {
      cv::resize(tmp, out, cv::Size(j.size, j.size), 0, 0, cv::INTER_LINEAR);
    } else {
      tmp.copyTo(out);
    }
  } else {
    cv::Mat resized;
    if (img.rows == j.size && img.cols == j.size) {
      resized = img;  // already target-sized (e.g. BBC 368 crop): bit-exact
    } else {
      cv::resize(img, resized, cv::Size(j.size, j.size));
    }
    resized.convertTo(out, CV_32FC3);
  }
  j.status = 0;
}

}  // namespace

extern "C" {

// Decode n images into out (n * size * size * 3 f32, BGR, 0..255).
// crops: nullptr or n*4 ints (x0,y0,w,h; x0=-1 disables).
// bottom_right: >0 applies the BBC-style bottom-right square crop.
// statuses: nullptr or n ints (0 ok / 1 unreadable).
// dims: nullptr or n*2 ints filled with the original (rows, cols) —
//   callers rescale keypoints from original-image coordinates without a
//   second header read.
// mode: 0 = u8 linear resize; 1 = Python TestResized float chain (Job doc).
// Returns number of failures.
int unipose_decode_batch(const char** paths, int n, int size, float* out,
                         const int* crops, int bottom_right, int* statuses,
                         int* dims, int n_threads, int mode) {
  std::vector<Job> jobs(n);
  for (int i = 0; i < n; ++i) {
    Job& j = jobs[i];
    j.path = paths[i];
    j.out = out + static_cast<size_t>(i) * 3 * size * size;
    j.size = size;
    if (crops) {
      j.crop_x0 = crops[i * 4 + 0];
      j.crop_y0 = crops[i * 4 + 1];
      j.crop_w = crops[i * 4 + 2];
      j.crop_h = crops[i * 4 + 3];
    } else {
      j.crop_x0 = -1;
      j.crop_y0 = j.crop_w = j.crop_h = 0;
    }
    j.bottom_right = bottom_right;
    j.mode = mode;
    j.status = 0;
  }

  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      run_job(jobs[i]);
    }
  };
  std::vector<std::thread> threads;
  int spawn = std::min(n_threads, n);
  threads.reserve(spawn);
  for (int t = 0; t < spawn; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();

  int failures = 0;
  for (int i = 0; i < n; ++i) {
    if (statuses) statuses[i] = jobs[i].status;
    if (dims) {
      dims[i * 2 + 0] = jobs[i].rows;
      dims[i * 2 + 1] = jobs[i].cols;
    }
    failures += jobs[i].status;
  }
  return failures;
}

// From-memory variant (serving: HTTP bodies hold encoded JPEG bytes, no
// files).  bufs[i]/lens[i] give each image's encoded bytes; everything
// else matches unipose_decode_batch.
int unipose_decode_batch_mem(const unsigned char** bufs, const int* lens,
                             int n, int size, float* out, const int* crops,
                             int bottom_right, int* statuses, int* dims,
                             int n_threads, int mode) {
  std::vector<Job> jobs(n);
  for (int i = 0; i < n; ++i) {
    Job& j = jobs[i];
    j.path = nullptr;
    j.buf = bufs[i];
    j.buf_len = lens[i];
    j.out = out + static_cast<size_t>(i) * 3 * size * size;
    j.size = size;
    if (crops) {
      j.crop_x0 = crops[i * 4 + 0];
      j.crop_y0 = crops[i * 4 + 1];
      j.crop_w = crops[i * 4 + 2];
      j.crop_h = crops[i * 4 + 3];
    } else {
      j.crop_x0 = -1;
      j.crop_y0 = j.crop_w = j.crop_h = 0;
    }
    j.bottom_right = bottom_right;
    j.mode = mode;
    j.status = 0;
  }

  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      run_job(jobs[i]);
    }
  };
  std::vector<std::thread> threads;
  int spawn = std::min(n_threads, n);
  threads.reserve(spawn);
  for (int t = 0; t < spawn; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();

  int failures = 0;
  for (int i = 0; i < n; ++i) {
    if (statuses) statuses[i] = jobs[i].status;
    if (dims) {
      dims[i * 2 + 0] = jobs[i].rows;
      dims[i * 2 + 1] = jobs[i].cols;
    }
    failures += jobs[i].status;
  }
  return failures;
}

}  // extern "C"
