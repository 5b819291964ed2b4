"""Export of the fused frame: torch.export, AOTInductor and a C++ runner
(``csrc/aoti_runner.cpp``, built by ``ops._build.build_runner``)."""

from mgnet_tpu_torch.export.aot import (
    BARS,
    INDUCTOR_NUMERICS,
    BarsMissed,
    compare_exact,
    compare_outputs,
    export_fused_inference,
    float64_shares,
    fnv1a64,
    load_exported,
    load_program,
    package_path,
    save_exported,
    shares,
)

__all__ = ["BARS", "BarsMissed", "INDUCTOR_NUMERICS", "compare_exact",
           "compare_outputs", "export_fused_inference", "float64_shares",
           "fnv1a64",
           "load_exported", "load_program", "package_path", "save_exported",
           "shares"]
