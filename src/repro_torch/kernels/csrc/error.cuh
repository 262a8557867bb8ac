// Every kernel library exports the CUDA runtime's message for its error
// codes (kernels/_build.py reads it when a launch function returns one).
#pragma once

#include <cuda_runtime.h>

extern "C" const char* rsm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
