// The head_dim 80 instance of the flash backward (flash_attention_bwd.cu).
#include "flash_attention_bwd.cuh"

template int launch_fb<80>(const void*, const void*, const void*,
                            const void*, const float*, const void*, void*,
                            void*, void*, float*, int, int, int, int, int,
                            int, int, float, cudaStream_t);
