"""Model families: the paper's analog LSTM."""
