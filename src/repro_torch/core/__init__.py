"""MX formats, specs, the converter and bit-packing, in plain PyTorch."""
from repro_torch.core.convert import (MXArray, decode_elements,  # noqa: F401
                                      mx_dequantize, mx_quantize,
                                      pow2_f32, scale_to_f32)
from repro_torch.core.formats import (ALL_FORMATS, FORMATS,  # noqa: F401
                                      MXFormat, get_format)
from repro_torch.core.mx_weight import MXWeight, params_nbytes  # noqa: F401
from repro_torch.core.pack import (pack_codes, pack_codes_rows,  # noqa: F401
                                   packed_nbytes, unpack_codes,
                                   unpack_codes_rows)
from repro_torch.core.spec import (QuantPolicy, QuantSpec,  # noqa: F401
                                   as_spec)
