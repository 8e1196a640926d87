"""Host-side data modules of the port (numpy only) and the latent data
module that encodes whole splits through the frozen VQ-VAE on the card."""
from .asimow import ASIMoWDataModule, load_asimow_csv
from .datasets import ArraySplit, make_autoregressive, sampling_weights
from .latent import LatentPredDataModule
from .scaler import StandardScaler
from .splits import DataSplitId, get_val_test_ids
