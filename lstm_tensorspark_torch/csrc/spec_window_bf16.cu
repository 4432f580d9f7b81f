// The bfloat16 form of the spec window (spec_window.cu), built as a library of
// its own so that its build runs beside the float32 form's: spec_window.cu
// with WINDOW_BF16 defined holds spec_window_bf16_launch alone.

#define WINDOW_BF16
#include "spec_window.cu"
