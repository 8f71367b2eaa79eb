from .plate import Plate
from .group import Group
from .data import Data
from .timeseries import Timeseries
from .param import OptParam, QEMParam
from .dist import Dist, new_dist, _dist_calls

# the user-facing constructor of every family (Normal, Beta, ...)
globals().update(_dist_calls)
