from .blocks import (  # noqa: F401
    BatchNorm,
    Conv,
    ConvBN,
    ConvBNRelu,
    Deconv2x2,
    DeconvBNRelu,
    Dense,
    DenseBN,
    DenseBNRelu,
    max_pool_2x2,
)
from .critic import DisC2DFCN1, init_critic  # noqa: F401
from .film import FilmSite, NoiseEncoder, film_modulate  # noqa: F401
from .generator import GenUNet2D, init_generator  # noqa: F401
