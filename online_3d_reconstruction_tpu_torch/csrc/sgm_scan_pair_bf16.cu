// The bfloat16 half of the SGM scan-pair kernels: sgm_scan_pair.cu compiled
// as a unit of its own, so that nvcc builds the float32 and the bfloat16
// kernels side by side. All the code is there.
#define O3R_SCAN_BF16_UNIT
#include "sgm_scan_pair.cu"
