"""AMP op lists: the port's copy of
``paddle_tpu/contrib/mixed_precision/fp16_lists.py`` (reference
contrib/mixed_precision/fp16_lists.py). White-list ops run in the
reduced dtype (bfloat16), black-list ops in float32, gray ones follow
their inputs."""

white_list = {
    "conv2d",
    "matmul",
    "matmul_v2",
    "mul",
    "flash_attention",
}

black_list = {
    "exp",
    "square",
    "log",
    "mean",
    "sum",
    "cos_sim",
    "softmax",
    "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits",
    "cross_entropy",
    "layer_norm",
    "batch_norm",
}

gray_list = {
    "elementwise_add",
    "elementwise_mul",
    "elementwise_sub",
    "relu",
    "gelu",
    "dropout",
    "transpose2",
    "reshape2",
    "concat",
    "split",
    "scale",
    "pool2d",
}


class AutoMixedPrecisionLists:
    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(white_list)
        self.black_list = set(black_list)
        self.gray_list = set(gray_list)
        if custom_white_list:
            self.white_list |= set(custom_white_list)
            self.black_list -= set(custom_white_list)
        if custom_black_list:
            self.black_list |= set(custom_black_list)
            self.white_list -= set(custom_black_list)
