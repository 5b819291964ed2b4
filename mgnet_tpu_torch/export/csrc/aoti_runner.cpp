// Native runtime of the exported fused frame, over AOTInductor.
//
// The counterpart of native/src/pjrt_runner.cpp (which compiles the JAX
// export's StableHLO through a PJRT plugin): this program loads the
// AOTInductor package that mgnet_tpu_torch/export/aot.py::save_exported
// writes (the whole frame, model + panoptic fusion + DGC depth, compiled
// with the weights inside), feeds it raw NHWC float32 frames and reports
// the steady-state latency per frame after a warmup, with no Python and no
// model code. The frame's mgnet::center_argmin op is registered by
// mgnet_ops.cpp, linked into this program with the kernel's object.
//
// Usage:
//   mgnet_aoti_runner <model.aoti.pt2> [input.raw|-] [iters] [H] [W]
//
// Inputs, as pjrt_runner.cpp's: the image [1, H, W, 3] f32 (the raw file
// of H x W x 3 f32, or 0.5 everywhere with "-" or no file), K [1, 3, 3]
// and the camera height [1]. Each timed frame ends in a synchronise of
// the device, as pjrt_runner.cpp waits for each frame. Last, one more
// frame's panoptic output (found by the package's output_keys metadata)
// is copied to the host and its bytes hashed (FNV-1a, 64 bits; the same
// as mgnet_tpu_torch.export.fnv1a64), and the center_argmin kernel's
// launches are printed beside the frames run: one each, or the runner
// fails.

#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#include <torch/cuda.h>

#include <ATen/ops/from_blob.h>

#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

// mgnet_ops.cpp: the center_argmin kernel's launches in this process
extern "C" long long mgnet_ops_center_argmin_launches();

static std::string read_file(const char* path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) {
    std::fprintf(stderr, "cannot open %s\n", path);
    std::exit(1);
  }
  return std::string(std::istreambuf_iterator<char>(f),
                     std::istreambuf_iterator<char>());
}

static uint64_t fnv1a64(const uint8_t* data, size_t n) {
  uint64_t h = 0xcbf29ce484222325ull;
  for (size_t i = 0; i < n; ++i) {
    h ^= data[i];
    h *= 0x100000001b3ull;
  }
  return h;
}

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr,
                 "usage: %s <model.aoti.pt2> [input.raw|-] [iters] [H] "
                 "[W]\n",
                 argv[0]);
    return 2;
  }
  const char* model_path = argv[1];
  const char* input_path =
      (argc > 2 && argv[2][0] != '-') ? argv[2] : nullptr;
  const int iters = argc > 3 ? std::atoi(argv[3]) : 50;
  const int64_t H = argc > 4 ? std::atoll(argv[4]) : 1024;
  const int64_t W = argc > 5 ? std::atoll(argv[5]) : 2048;

  auto t_load0 = std::chrono::steady_clock::now();
  torch::inductor::AOTIModelPackageLoader loader(model_path);
  const double load_s = std::chrono::duration<double>(
                            std::chrono::steady_clock::now() - t_load0)
                            .count();
  auto meta = loader.get_metadata();
  std::vector<std::string> keys;
  {
    std::stringstream ss(meta["output_keys"]);
    for (std::string key; std::getline(ss, key, ',');) keys.push_back(key);
  }
  int panoptic = -1;
  for (size_t i = 0; i < keys.size(); ++i)
    if (keys[i] == "panoptic") panoptic = static_cast<int>(i);
  if (panoptic < 0) {
    std::fprintf(stderr, "%s: no panoptic output (output_keys '%s')\n",
                 model_path, meta["output_keys"].c_str());
    return 1;
  }
  const std::string device = meta["AOTI_DEVICE_KEY"];
  const bool cuda = device == "cuda";
  std::printf("loaded %s in %.1f s: device %s, outputs %s\n", model_path,
              load_s, device.c_str(), meta["output_keys"].c_str());

  std::vector<float> image(static_cast<size_t>(H) * W * 3, 0.5f);
  if (input_path) {
    std::string raw = read_file(input_path);
    if (raw.size() != image.size() * sizeof(float)) {
      std::fprintf(stderr, "input size mismatch: got %zu want %zu\n",
                   raw.size(), image.size() * sizeof(float));
      return 1;
    }
    std::memcpy(image.data(), raw.data(), raw.size());
  }
  float K[9] = {2262.52f, 0.f, 1096.98f, 0.f, 2265.30f, 513.137f,
                0.f, 0.f, 1.f};
  float cam_height[1] = {1.22f};
  const auto f32 = at::TensorOptions().dtype(at::kFloat);
  const at::Device dev = cuda ? at::Device(at::kCUDA, 0) : at::Device("cpu");
  std::vector<at::Tensor> inputs = {
      at::from_blob(image.data(), {1, H, W, 3}, f32).to(dev),
      at::from_blob(K, {1, 3, 3}, f32).to(dev),
      at::from_blob(cam_height, {1}, f32).to(dev),
  };
  auto sync = [&] {
    if (cuda) torch::cuda::synchronize();
  };

  // warmup x10, then steady state with a synchronise per frame
  for (int i = 0; i < 10; ++i) loader.run(inputs);
  sync();
  auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    loader.run(inputs);
    sync();
  }
  const double dt =
      std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
          .count();
  std::printf("latency: %.3f ms/frame  (%.1f fps) over %d iters  [%s, "
              "synchronised per frame]\n",
              dt / iters * 1e3, iters / dt, iters, device.c_str());

  // completion proof: one more frame, its panoptic output read back and
  // hashed
  std::vector<at::Tensor> outs = loader.run(inputs);
  at::Tensor pan = outs.at(panoptic).contiguous().cpu();
  const auto* bytes = static_cast<const uint8_t*>(pan.data_ptr());
  const size_t n = pan.numel() * pan.element_size();
  std::printf("output[panoptic] readback: %zu bytes, fnv1a=%016llx\n", n,
              static_cast<unsigned long long>(fnv1a64(bytes, n)));
  const long long frames = 10 + iters + 1;
  const long long launches = mgnet_ops_center_argmin_launches();
  std::printf("center_argmin launches: %lld in %lld frames\n", launches,
              frames);
  if (cuda && launches != frames) {
    std::fprintf(stderr, "expected one center_argmin launch a frame\n");
    return 1;
  }
  return 0;
}
