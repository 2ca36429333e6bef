// The depthwise kernels' fixed tile shape: the one place it is set. The
// CUDA sources (depthwise_conv.cu: #1, depthwise_grad_weight.cu: #2)
// include this header, and the wrapper s2tpu_torch/ops/depthwise_conv.py
// reads the `#define DW_<NAME> <value>` lines below for its tile plans, so
// the plans describe what the kernels launch. Keep one definition a line.

#pragma once

#define DW_MAX_THREADS 256  // threads a block, both kernels' __launch_bounds__
#define DW_FWD_RY 2         // #1: outputs along H per thread
#define DW_FWD_RX 4         // #1: outputs along W per thread
#define DW_GRAD_STAGES 2    // #2: row groups in shared memory at once
