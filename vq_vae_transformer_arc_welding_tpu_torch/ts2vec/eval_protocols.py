"""scikit-learn probes of TS2Vec representations.

Port of vq_vae_transformer_arc_welding_tpu/ts2vec/eval_protocols.py
(`fit_svm`, `fit_lr`, `fit_knn`, `fit_ridge`; the reference's
model/ts2vec/_eval_protocols.py). scikit-learn is imported inside each
function, so the module imports where it is not installed.
"""
from __future__ import annotations

import numpy as np


def fit_svm(features, y, MAX_SAMPLES=20_000):
    from sklearn.model_selection import GridSearchCV, train_test_split
    from sklearn.svm import SVC
    features = np.nan_to_num(features)
    nb_classes = np.unique(y, return_counts=True)[1].shape[0]
    train_size = features.shape[0]
    svm = SVC(C=np.inf, gamma="scale")
    if train_size // nb_classes < 5 or train_size < 50:
        return svm.fit(features, y)
    grid_search = GridSearchCV(
        svm, {"C": [0.1], "kernel": ["rbf"], "gamma": ["scale"],
              "max_iter": [20_000], "decision_function_shape": ["ovr"]},
        cv=5, n_jobs=-1)
    if train_size > MAX_SAMPLES:
        split = train_test_split(features, y, train_size=MAX_SAMPLES,
                                 random_state=42, stratify=y)
        features, y = split[0], split[2]
    grid_search.fit(features, y)
    return grid_search.best_estimator_


def fit_lr(features, y, MAX_SAMPLES=100000):
    from sklearn.linear_model import LogisticRegression
    from sklearn.model_selection import train_test_split
    from sklearn.pipeline import make_pipeline
    from sklearn.preprocessing import StandardScaler
    if features.shape[0] > MAX_SAMPLES:
        split = train_test_split(features, y, train_size=MAX_SAMPLES,
                                 random_state=0, stratify=y)
        features, y = split[0], split[2]
    pipe = make_pipeline(
        StandardScaler(),
        LogisticRegression(random_state=0, max_iter=1000000))
    pipe.fit(features, y)
    return pipe


def fit_knn(features, y):
    from sklearn.neighbors import KNeighborsClassifier
    from sklearn.pipeline import make_pipeline
    from sklearn.preprocessing import StandardScaler
    pipe = make_pipeline(StandardScaler(), KNeighborsClassifier(n_neighbors=1))
    pipe.fit(features, y)
    return pipe


def fit_ridge(train_features, train_y, valid_features, valid_y,
              MAX_SAMPLES=100000):
    if train_features.shape[0] > MAX_SAMPLES:
        split = train_test_split(train_features, train_y,
                                 train_size=MAX_SAMPLES, random_state=0)
        train_features, train_y = split[0], split[2]
    if valid_features.shape[0] > MAX_SAMPLES:
        split = train_test_split(valid_features, valid_y,
                                 train_size=MAX_SAMPLES, random_state=0)
        valid_features, valid_y = split[0], split[2]
    alphas = [0.1, 0.2, 0.5, 1, 2, 5, 10, 20, 50, 100, 200, 500, 1000]
    scores = []
    for alpha in alphas:
        lr = Ridge(alpha=alpha).fit(train_features, train_y)
        pred = lr.predict(valid_features)
        scores.append(np.sqrt(((pred - valid_y) ** 2).mean())
                      + np.abs(pred - valid_y).mean())
    best_alpha = alphas[int(np.argmin(scores))]
    return Ridge(alpha=best_alpha).fit(train_features, train_y)
