// The custom op mgnet::center_argmin for a C++ process.
//
// The exported frame (mgnet_tpu_torch/export/aot.py) calls the
// hand-written center_argmin kernel as the opaque op mgnet::center_argmin,
// which AOTInductor's generated code reaches through its proxy executor,
// that is through the dispatcher. A Python process registers the op with
// torch.library.custom_op (mgnet_tpu_torch/ops/center_argmin.py); a C++
// process such as aoti_runner.cpp has no Python, so this file registers
// the same schema (the string is the Python op's, character for
// character: tests/test_torch_ops_registry.py compares them) with a CUDA
// kernel that launches the same C entry, mgnet_center_argmin of
// ops/csrc/center_argmin.cu, on the current stream, after the checks of
// the Python wrapper, and counts its launches. There is no CPU kernel: the
// runner runs a package exported on the card.

#include <atomic>

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <c10/core/DeviceGuard.h>
#include <c10/core/impl/DeviceGuardImplInterface.h>
#include <torch/library.h>

extern "C" int mgnet_center_argmin(const void* py, const void* px,
                                   const void* cy, const void* cx,
                                   const void* c2, void* out,
                                   long long batch, int h, int w, int k,
                                   void* kept_pairs, void* stream);

namespace {

std::atomic<long long> launches{0};

// ops/center_argmin.py: MAX_CENTERS, _MAX_BATCH, _MAX_TILE_ROWS, TILE_H
constexpr int64_t kMaxCenters = 4096;
constexpr int64_t kMaxBatch = 65535;
constexpr int64_t kMaxTileRows = 65535;
constexpr int64_t kTileH = 32;

at::Tensor center_argmin_cuda(const at::Tensor& py, const at::Tensor& px,
                              const at::Tensor& cy, const at::Tensor& cx,
                              const at::Tensor& c2) {
  for (const at::Tensor* t : {&py, &px, &cy, &cx, &c2}) {
    TORCH_CHECK(t->scalar_type() == at::kFloat,
                "center_argmin: inputs must be float32, got ",
                t->scalar_type());
    TORCH_CHECK(t->device() == py.device(), "center_argmin: inputs on ",
                t->device(), " and ", py.device());
    TORCH_CHECK(t->is_contiguous(), "center_argmin: inputs must be "
                "contiguous");
  }
  TORCH_CHECK(py.is_cuda(), "center_argmin: unsupported device ",
              py.device());
  TORCH_CHECK(py.dim() == 3 && px.sizes() == py.sizes(),
              "center_argmin: py, px must be one [B, H, W] shape, got ",
              py.sizes(), ", ", px.sizes());
  const int64_t b = py.size(0), h = py.size(1), w = py.size(2);
  TORCH_CHECK(cy.dim() == 2 && cy.size(0) == b && cx.sizes() == cy.sizes()
                  && c2.sizes() == cy.sizes(),
              "center_argmin: cy, cx, c2 must be [B=", b, ", K], got ",
              cy.sizes(), ", ", cx.sizes(), ", ", c2.sizes());
  const int64_t k = cy.size(1);
  TORCH_CHECK(k >= 1 && k <= kMaxCenters, "center_argmin: K=", k,
              " outside [1, ", kMaxCenters, "]");
  TORCH_CHECK(b <= kMaxBatch, "center_argmin: batch ", b, " > ", kMaxBatch);
  TORCH_CHECK((h + kTileH - 1) / kTileH <= kMaxTileRows && w < (1LL << 31),
              "center_argmin: plane ", h, "x", w, " too large");
  c10::DeviceGuard guard(py.device());
  at::Tensor out = at::empty({b, h, w}, py.options().dtype(at::kInt));
  void* stream = c10::impl::getDeviceGuardImpl(c10::DeviceType::CUDA)
                     ->getStream(py.device())
                     .native_handle();
  const int rc = mgnet_center_argmin(
      py.data_ptr(), px.data_ptr(), cy.data_ptr(), cx.data_ptr(),
      c2.data_ptr(), out.data_ptr(), b, static_cast<int>(h),
      static_cast<int>(w), static_cast<int>(k), nullptr, stream);
  TORCH_CHECK(rc == 0, "center_argmin: kernel launch failed (cudaError ",
              rc, ")");
  launches.fetch_add(1);
  return out;
}

}  // namespace

// The kernel's launches in this process, as center_argmin.launches counts
// them in Python: one where the kernel is launched.
extern "C" long long mgnet_ops_center_argmin_launches() {
  return launches.load();
}

TORCH_LIBRARY(mgnet, m) {
  m.def("center_argmin(Tensor py, Tensor px, Tensor cy, Tensor cx, "
        "Tensor c2) -> Tensor");
}

TORCH_LIBRARY_IMPL(mgnet, CUDA, m) {
  m.impl("center_argmin", &center_argmin_cuda);
}
