"""Finance data pipeline."""

from kmpc_tpu_torch.data.finance import FinanceData, load_finance_data

__all__ = ["FinanceData", "load_finance_data"]
