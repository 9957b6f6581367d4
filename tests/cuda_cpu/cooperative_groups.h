// The stand-in's cooperative groups (tests/cuda_cpu/cuda_runtime.h holds
// the cluster API the kernel uses: this_cluster(), sync(), block_rank(),
// map_shared_rank()).
#pragma once

#include "cuda_runtime.h"
