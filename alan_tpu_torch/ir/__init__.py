from .plate import Plate
from .group import Group
from .data import Data
from .timeseries import Timeseries
from .param import OptParam, QEMParam
from .dist import Dist, Normal, Bernoulli, NegativeBinomial, Beta
