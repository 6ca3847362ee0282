"""Paper applications on the port's collection substrate: K-Means,
MolDyn, PlhamJ.  Each keeps its data on the CUDA card unless the caller
asks for the CPU (``device="cpu"``)."""
from .kmeans import AveragePosition, ClosestPoint, KMeans
from .moldyn import MolDyn
from .plham import PlhamSim

__all__ = ["AveragePosition", "ClosestPoint", "KMeans", "MolDyn", "PlhamSim"]
