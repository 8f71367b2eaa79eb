from .families import FAMILIES, Family
from .dimdist import DimDist
