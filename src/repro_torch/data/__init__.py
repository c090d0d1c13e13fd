from repro_torch.data.synthetic import SyntheticLMDataset, zipf_markov_stream
