// The port's native runtime (its own copy of leclip_tpu/runtime/decode.cpp):
// multithreaded JPEG decode. libjpeg decode fanned out over a std::thread
// pool, writing straight into caller-owned buffers (numpy arrays) with zero
// copies on the Python side. C ABI only, bound with ctypes (runtime/jpeg.py).
//
// Built against the libjpeg-turbo headers in include/ (JPEG ABI 62) and
// linked against an ABI-62 libjpeg found at run time: the one Pillow's wheel
// bundles, else the system's. runtime/jpeg.py builds it; by hand:
//   g++ -O3 -shared -fPIC -Iinclude -o libleclip_decode.so decode.cpp \
//       /path/to/libjpeg.so.62 -Wl,-rpath,/path/to -lpthread

#include <atomic>
#include <csetjmp>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include "jpeglib.h"

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Silence libjpeg's stderr warning spam ("extraneous bytes before marker…")
// — at batch throughput the stderr writes dominate wall time.
void emit_message(j_common_ptr, int) {}
void output_message(j_common_ptr) {}

// Decode one in-memory JPEG into an RGB8 buffer of capacity `cap` bytes.
// Returns 0 on success, -1 decode error, -2 buffer too small.
int decode_one(const unsigned char* data, size_t len, unsigned char* out,
               long cap, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = emit_message;
  jerr.pub.output_message = output_message;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int height = cinfo.output_height;
  const int width = cinfo.output_width;
  const long needed = static_cast<long>(height) * width * 3;
  if (needed > cap) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  const int stride = width * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = out + static_cast<long>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *h = height;
  *w = width;
  return 0;
}

}  // namespace

extern "C" {

// The library's ABI against these headers: jpeg_CreateDecompress with this
// JPEG_LIB_VERSION and this struct size, which a library of another ABI
// refuses (JERR_BAD_LIB_VERSION / JERR_BAD_STRUCT_SIZE). Returns 0 when it
// accepts them, else libjpeg's message code; *version and *struct_size get
// what was asked for.
int leclip_jpeg_abi(int* version, long* struct_size) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  *version = JPEG_LIB_VERSION;
  *struct_size = static_cast<long>(sizeof(jpeg_decompress_struct));
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = emit_message;
  jerr.pub.output_message = output_message;
  if (setjmp(jerr.setjmp_buffer)) {
    return jerr.pub.msg_code != 0 ? jerr.pub.msg_code : -1;
  }
  jpeg_CreateDecompress(&cinfo, JPEG_LIB_VERSION, sizeof(jpeg_decompress_struct));
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Header-only parse → dimensions. Returns 0 on success.
int leclip_jpeg_dims(const unsigned char* data, size_t len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.emit_message = emit_message;
  jerr.pub.output_message = output_message;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int leclip_decode_jpeg(const unsigned char* data, size_t len, unsigned char* out,
                       long cap, int* h, int* w) {
  return decode_one(data, len, out, cap, h, w);
}

// Batched decode over a worker pool. rc[i] gets the per-image status.
// Returns the number of failures.
int leclip_decode_jpeg_batch(int n, const unsigned char** datas,
                             const size_t* lens, unsigned char** outs,
                             const long* caps, int* hs, int* ws, int* rc,
                             int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  auto worker = [&]() {
    while (true) {
      const int i = next.fetch_add(1);
      if (i >= n) break;
      rc[i] = decode_one(datas[i], lens[i], outs[i], caps[i], &hs[i], &ws[i]);
      if (rc[i] != 0) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  const int workers = n_threads < n ? n_threads : n;
  pool.reserve(workers);
  for (int t = 0; t < workers; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
