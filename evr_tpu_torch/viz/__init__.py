from .projection import generate_visualization, project_embeddings
from .umap import umap

__all__ = ["generate_visualization", "project_embeddings", "umap"]
