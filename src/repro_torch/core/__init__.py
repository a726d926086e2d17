"""MX formats, specs, the converter and bit-packing, in plain PyTorch."""
from repro_torch.core.convert import (MXArray,  # noqa: F401
                                      block_max_exponent, decode_elements,
                                      max_exponent_tree, mx_dequantize,
                                      mx_error_bound, mx_quantize, pow2_f32,
                                      quantize_dequantize, scale_to_f32)
from repro_torch.core.formats import (ALL_FORMATS, FORMATS,  # noqa: F401
                                      MXFormat, get_format)
from repro_torch.core.mx_weight import (MXWeight,  # noqa: F401
                                        mx_weight_nbytes, params_nbytes)
from repro_torch.core.pack import (pack_codes, pack_codes_rows,  # noqa: F401
                                   packed_nbytes, unpack_codes,
                                   unpack_codes_rows)
from repro_torch.core.spec import (PolicyTable, QuantPolicy,  # noqa: F401
                                   QuantSpec, as_spec)
