"""Model families: the paper's analog LSTM and the dense LM."""
